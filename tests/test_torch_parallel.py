"""The port's multi-device prove (tstwo_tpu_torch/parallel) against the JAX
package's, on the CPU with gloo (tolerance 0).

Each group of ranks is a set of real processes joined by
`torch.distributed` over a `file://` store in the test's temporary
directory (no TCP port, so parallel test workers cannot collide), every
one under a timeout.  A rank runs the tasks of its group on its slice of
the columns, gathers what it computed and writes it to disk; the tests
here hold those results against the JAX package on the same seeded numpy
inputs:

  * the sharded CFFT at D = 1, 2, 4, forward and inverse, single and
    batched columns, log_n from 2k (k = log2 D, at least 3) to 10, against
    the port's single-device transform, and against JAX `make_sharded_fft`
    on D of the conftest's 8 virtual devices at log_n 8;
  * `sharded_fold_line`, `sharded_accumulate_quotients`, the sharded leaf
    layer and the full sharded Merkle commit and decommit (columns above,
    at and under the sharding threshold) against the JAX functions;
  * the sharded Poseidon252 tree (the same columns) against the port's
    single-device Poseidon252 tree, which tests/test_torch_poseidon_merkle.py
    holds against JAX, and its top layers from a non-contiguous view of
    the gathered subroots;
  * `prove_wide_fibonacci(8, 8)` at D = 1, 2, 4 and on a 2 x 2 mesh,
    against the committed JAX proof, and `prove_basic_air(6)` at D = 4
    against the JAX single-device proof: every rank's proof is the same,
    the port's verifier accepts it, and each rank's Merkle leaves covered
    n/D rows of every sharded column;
  * `prove_basic_air(4, flavor="poseidon252")` at D = 1, 2, 4 and on a
    2 x 2 mesh, field by field against the committed JAX proof, which is
    also the JAX package's own mesh proof on 4 virtual devices;
  * a JAX mesh checkpoint (8 virtual devices) loaded into the port at D = 2
    finishes to the JAX proof's bytes, and a Poseidon252 checkpoint loaded
    under a mesh rebuilds a Poseidon252 tree.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "data",
                       "torch_port_wide_fib_log8x8_seed0.json")
P = (1 << 31) - 1
GROUP_TIMEOUT_S = 240
MERKLE_LOGS = (10, 10, 8, 3, 1)
MERKLE_QUERIES = {10: [0, 5, 511, 512, 1023], 8: [3, 200], 3: [1, 6],
                  1: [0]}
BASIC_AIR_LOG = 6
POSEIDON_LOG = 4  # a CPU Poseidon252 prove there takes ~25 s a rank
POSEIDON_FIXTURE = os.path.join(REPO, "tests", "data",
                                "torch_port_basic_air_poseidon_log4.json")


def fft_logs(size):
    """2k to 10, from 3 up: a domain of 4 points has no circle twiddles
    of the generic layout (its transform is special-cased, unsharded)."""
    k = size.bit_length() - 1
    return range(max(2 * k, 3), 11)


def fft_input(log_n, batch):
    rng = np.random.default_rng(1000 * log_n + (batch or 0))
    vals = rng.integers(0, P, size=(batch or 1, 1 << log_n), dtype=np.uint32)
    return vals if batch else vals[0]


def merkle_columns():
    rng = np.random.default_rng(5)
    return [rng.integers(0, P, size=1 << log, dtype=np.uint32)
            for log in MERKLE_LOGS]


def fold_inputs():
    rng = np.random.default_rng(1)
    vals = rng.integers(0, P, size=(4, 256), dtype=np.uint32)
    itw = rng.integers(1, P, size=128, dtype=np.uint32)
    return vals, itw


def quotient_columns():
    rng = np.random.default_rng(0)
    return [rng.integers(0, P, size=1 << 8, dtype=np.uint32)
            for _ in range(3)]


def leaf_columns():
    rng = np.random.default_rng(2)
    return [rng.integers(0, P, size=64, dtype=np.uint32) for _ in range(2)]


# The program of one rank: argv is rank, size, store, out dir, mesh shape
# ("1d" or "2x2"), the tasks (comma-separated) and an optional checkpoint.
# It imports the port and this file's input helpers (the file imports JAX
# only inside its tests), never JAX.
_RANK = textwrap.dedent("""
    import json, sys
    sys.path.insert(0, %(repo)r)
    sys.path.insert(0, %(tests)r)
    rank, size, store, out_dir, shape, tasks = (
        int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
        sys.argv[5], sys.argv[6].split(","))
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from tstwo_tpu_torch.parallel import (init_distributed, make_mesh,
                                          make_mesh2d)
    init_distributed("gloo", "file://" + store, rank, size, timeout_s=60)
    mesh = (make_mesh(device="cpu") if shape == "1d"
            else make_mesh2d(2, size // 2, device="cpu"))
    import test_torch_parallel as T
    from tstwo_tpu_torch.circle import CanonicCoset
    from tstwo_tpu_torch.parallel.fft import make_sharded_fft, shard_column
    from tstwo_tpu_torch.parallel.ops import gather_points
    from tstwo_tpu_torch.poly.twiddles import (circle_layer_twiddles,
                                               domain_line_twiddles,
                                               precompute_twiddles)
    from tstwo_tpu_torch.serialize import proof_to_dict
    from tstwo_tpu_torch.utils import to_numpy_u32, to_torch_u32

    arrays, out = {}, {"rank": rank, "mesh": repr(mesh)}

    def whole(local):
        return to_numpy_u32(gather_points(mesh, local))

    if "fft" in tasks:
        for log_n in T.fft_logs(size):
            tree = precompute_twiddles(
                CanonicCoset.new(log_n).circle_domain().half_coset)
            for inverse in (False, True):
                line = domain_line_twiddles(log_n, tree, inverse, "cpu")
                fn = make_sharded_fft(mesh, log_n, line,
                                      circle_layer_twiddles(line[0]), inverse)
                for batch in (0, 3):
                    vals = to_torch_u32(T.fft_input(log_n, batch))
                    arrays[f"fft_{log_n}_{int(inverse)}_{batch}"] = whole(
                        fn(shard_column(vals, mesh)))

    if "ops" in tasks:
        from tstwo_tpu_torch.circle import SECURE_FIELD_CIRCLE_GEN
        from tstwo_tpu_torch.fields import QM31
        from tstwo_tpu_torch.ops import qm31 as qm31_ops
        from tstwo_tpu_torch.parallel.merkle import ShardedMerkleProver
        from tstwo_tpu_torch.parallel.ops import (
            sharded_accumulate_quotients, sharded_fold_line,
            sharded_merkle_leaf_layer, shard_points)
        from tstwo_tpu_torch.pcs.quotients import (ColumnSampleBatch,
                                                   PointSample)

        vals, itw = T.fold_inputs()
        alpha = qm31_ops.scalar(QM31.from_u32_unchecked(1, 2, 3, 4),
                                device="cpu")
        arrays["fold"] = whole(sharded_fold_line(
            mesh, to_torch_u32(vals), to_torch_u32(itw), alpha))

        domain = CanonicCoset.new(8).circle_domain()
        samples = [[PointSample(SECURE_FIELD_CIRCLE_GEN,
                                QM31.from_u32_unchecked(i + 1, 2, 3, 4))]
                   for i in range(3)]
        q = sharded_accumulate_quotients(
            mesh, domain, [to_torch_u32(c) for c in T.quotient_columns()],
            QM31.from_u32_unchecked(9, 8, 7, 6),
            ColumnSampleBatch.new_vec(samples), 1)
        arrays["quotients"] = whole(q.values)

        arrays["leaf"] = whole(sharded_merkle_leaf_layer(
            mesh, [to_torch_u32(c) for c in T.leaf_columns()], 6))

        cols = [to_torch_u32(c) for c in T.merkle_columns()]
        cols = [shard_points(mesh, c) if mesh.shards(log) else c
                for c, log in zip(cols, T.MERKLE_LOGS)]
        tree = ShardedMerkleProver.commit(mesh, cols, T.MERKLE_LOGS)
        queried, dec = tree.decommit(T.MERKLE_QUERIES, cols, T.MERKLE_LOGS)
        out["merkle"] = {
            "root": tree.root().hex(), "sharded": tree.sharded,
            "queried": [v.value for v in queried],
            "hash_witness": [h.hex() for h in dec.hash_witness],
            "column_witness": [v.value for v in dec.column_witness]}

        # the collectives themselves, and what they count
        mesh.reset_counts()
        rows = torch.arange(size * 3, dtype=torch.int32).reshape(size, 3)
        out["all_to_all"] = mesh.all_to_all(rows + 100 * rank).tolist()
        out["broadcast"] = mesh.broadcast(
            torch.tensor([rank + 7], dtype=torch.int32), src=size - 1).item()
        out["traffic"] = json.loads(json.dumps(mesh.traffic))

    if "poseidon_tree" in tasks:
        from tstwo_tpu_torch.parallel.merkle import ShardedMerkleProver
        from tstwo_tpu_torch.parallel.ops import shard_points
        from tstwo_tpu_torch.vcs.ops import Poseidon252MerkleOps

        cols = [to_torch_u32(c) for c in T.merkle_columns()]
        cols = [shard_points(mesh, c) if mesh.shards(log) else c
                for c, log in zip(cols, T.MERKLE_LOGS)]
        tree = ShardedMerkleProver.commit(mesh, cols, T.MERKLE_LOGS,
                                          Poseidon252MerkleOps)
        queried, dec = tree.decommit(T.MERKLE_QUERIES, cols, T.MERKLE_LOGS)
        out["poseidon_merkle"] = T.poseidon_tree_result(
            tree.root(), tree.sharded, queried, dec)

    if "poseidon" in tasks:
        import pickle

        from tstwo_tpu_torch.examples.basic_air import prove_basic_air

        mesh.reset_counts()
        proof, _, _ = prove_basic_air(T.POSEIDON_LOG, flavor="poseidon252",
                                      mesh=mesh)
        # felt digests have no proof_to_dict: the test encodes the proof
        out["poseidon_pickle"] = f"{out_dir}/poseidon{rank}.pkl"
        with open(out["poseidon_pickle"], "wb") as f:
            pickle.dump(proof, f)
        out["poseidon_leaf_rows"] = mesh.leaf_rows

    def proof_json(proof):
        return json.dumps(proof_to_dict(proof), sort_keys=True)

    if "wide_fib" in tasks:
        from tstwo_tpu_torch.examples.wide_fibonacci import (
            prove_wide_fibonacci, verify_wide_fibonacci)

        mesh.reset_counts()
        proof, comp, cfg = prove_wide_fibonacci(8, 8, seed=0, mesh=mesh)
        verify_wide_fibonacci(proof, comp, cfg, 8)
        out["wide_fib"] = proof_json(proof)
        out["wide_fib_leaf_rows"] = mesh.leaf_rows

    if "basic_air" in tasks:
        from tstwo_tpu_torch.examples.basic_air import (prove_basic_air,
                                                        verify_basic_air)

        mesh.reset_counts()
        proof, comp, cfg = prove_basic_air(T.BASIC_AIR_LOG, mesh=mesh)
        verify_basic_air(proof, comp, cfg, T.BASIC_AIR_LOG)
        out["basic_air"] = proof_json(proof)
        out["basic_air_leaf_rows"] = mesh.leaf_rows

    if "port_checkpoint" in tasks:
        from tstwo_tpu_torch.channel.blake2s import Blake2sChannel
        from tstwo_tpu_torch.examples.basic_air import generate_trace
        from tstwo_tpu_torch.pcs import PcsConfig
        from tstwo_tpu_torch.pcs.prover import CommitmentSchemeProver
        from tstwo_tpu_torch.poly.circle_poly import CircleEvaluation
        from tstwo_tpu_torch.serialize import save_prover_checkpoint
        from tstwo_tpu_torch.utils import to_host

        log = T.BASIC_AIR_LOG
        twiddles = precompute_twiddles(
            CanonicCoset.new(log + 2).circle_domain().half_coset)
        domain = CanonicCoset.new(log).circle_domain()
        channel = Blake2sChannel()
        scheme = CommitmentSchemeProver(PcsConfig(), twiddles, mesh=mesh)
        tb = scheme.tree_builder()
        tb.extend_evals([])
        tb.commit(channel)
        channel.mix_u64(log)
        tb = scheme.tree_builder()
        tb.extend_evals([CircleEvaluation(domain, c)
                         for c in generate_trace(log, device="cpu")])
        tb.commit(channel)
        ev = scheme.trees[1].evaluations[0]
        out["to_host_sharded"] = ev.mesh is not None
        arrays["to_host"] = to_host(ev)
        save_prover_checkpoint(f"{out_dir}/port_mesh.npz", scheme, channel)

    if "checkpoint" in tasks:
        from tstwo_tpu_torch.constraint_framework import (
            FrameworkComponent, TraceLocationAllocator)
        from tstwo_tpu_torch.examples.basic_air import TestEval
        from tstwo_tpu_torch.fields import QM31
        from tstwo_tpu_torch.pcs import PcsConfig
        from tstwo_tpu_torch.prover import prove
        from tstwo_tpu_torch.serialize import load_prover_checkpoint

        twiddles = precompute_twiddles(CanonicCoset.new(
            T.BASIC_AIR_LOG + 2).circle_domain().half_coset)
        try:
            load_prover_checkpoint(sys.argv[7], twiddles, device="cpu")
            out["refused"] = False
        except ValueError as e:
            out["refused"] = "mesh-sharded" in str(e)
        scheme, channel = load_prover_checkpoint(sys.argv[7], twiddles,
                                                 mesh=mesh)
        out["sharded_evals"] = sum(ev.mesh is not None for t in scheme.trees
                                   for ev in t.evaluations)
        component = FrameworkComponent(
            TraceLocationAllocator(), TestEval(T.BASIC_AIR_LOG), QM31.zero())
        out["checkpoint"] = proof_json(prove([component], channel, scheme))

    np.savez(f"{out_dir}/rank{rank}.npz", **arrays)
    with open(f"{out_dir}/rank{rank}.json", "w") as f:
        json.dump(out, f)
""") % {"repo": REPO, "tests": os.path.join(REPO, "tests")}


def start_group(tmp_dir, size, tasks, shape="1d", extra=()):
    """Start `size` ranks of the tasks, each writing its output under
    `tmp_dir`; (tmp_dir, processes)."""
    os.makedirs(tmp_dir, exist_ok=True)
    store = os.path.join(tmp_dir, "store")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    return tmp_dir, [subprocess.Popen(
        [sys.executable, "-c", _RANK, str(r), str(size), store, tmp_dir,
         shape, ",".join(tasks), *extra],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, cwd=REPO)
        for r in range(size)]


def finish_group(group):
    """Wait for a started group (every rank is killed at the timeout);
    every rank's (arrays, results)."""
    tmp_dir, procs = group
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=GROUP_TIMEOUT_S)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, (f"rank {r} of {len(procs)} failed:\n"
                                   f"{log[-4000:]}")
    results = []
    for r in range(len(procs)):
        with open(os.path.join(tmp_dir, f"rank{r}.json")) as f:
            res = json.load(f)
        results.append((dict(np.load(os.path.join(tmp_dir,
                                                  f"rank{r}.npz"))), res))
    return results


GROUPS = {  # name -> (ranks, tasks, mesh shape)
    "d1": (1, ("fft", "ops", "wide_fib", "poseidon_tree", "poseidon"), "1d"),
    "d2": (2, ("fft", "ops", "wide_fib", "poseidon_tree", "poseidon"), "1d"),
    "d4": (4, ("fft", "ops", "wide_fib", "basic_air", "poseidon_tree",
               "poseidon"), "1d"),
    "2x2": (4, ("wide_fib", "poseidon"), "2x2"),
}


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """Every group's ranks, started together and run once for the file."""
    base = tmp_path_factory.mktemp("mesh")
    started = {name: start_group(str(base / name), size, tasks, shape)
               for name, (size, tasks, shape) in GROUPS.items()}
    return {name: finish_group(group) for name, group in started.items()}


def _ranks_of(size):
    return {1: "d1", 2: "d2", 4: "d4"}[size]


# -- the sharded CFFT ---------------------------------------------------------

def _port_single(log_n, inverse, values):
    from tstwo_tpu_torch.circle import CanonicCoset
    from tstwo_tpu_torch.poly import circle_poly
    from tstwo_tpu_torch.poly.twiddles import precompute_twiddles
    from tstwo_tpu_torch.utils import to_numpy_u32, to_torch_u32

    domain = CanonicCoset.new(log_n).circle_domain()
    tree = precompute_twiddles(domain.half_coset)
    fn = (circle_poly.interpolate_values if inverse
          else circle_poly.evaluate_values)
    return to_numpy_u32(fn(to_torch_u32(values), domain, tree))


FFT_CASES = [(size, log_n, inverse, batch)
             for size in (1, 2, 4) for log_n in fft_logs(size)
             for inverse in (False, True) for batch in (0, 3)]


@pytest.mark.parametrize("size,log_n,inverse,batch", FFT_CASES)
def test_sharded_fft_equals_the_single_device_transform(groups, size, log_n,
                                                        inverse, batch):
    want = _port_single(log_n, inverse, fft_input(log_n, batch))
    for arrays, _ in groups[_ranks_of(size)]:
        np.testing.assert_array_equal(
            arrays[f"fft_{log_n}_{int(inverse)}_{batch}"], want)


@pytest.mark.parametrize("size", [1, 2, 4])
@pytest.mark.parametrize("inverse", [False, True])
def test_sharded_fft_equals_jax_make_sharded_fft(groups, size, inverse):
    import jax.numpy as jnp

    from tstwo_tpu.circle import CanonicCoset
    from tstwo_tpu.parallel.fft import make_sharded_fft, shard_column
    from tstwo_tpu.parallel.mesh import make_mesh
    from tstwo_tpu.poly.twiddles import (circle_layer_twiddles,
                                         domain_line_twiddles,
                                         precompute_twiddles)

    log_n = 8
    tree = precompute_twiddles(CanonicCoset.new(log_n).circle_domain()
                               .half_coset)
    line = domain_line_twiddles(log_n, tree, inverse)
    circ = circle_layer_twiddles(line[0])
    mesh = make_mesh(size)
    for batch in (0, 3):
        fn = make_sharded_fft(mesh, log_n, line, circ, inverse=inverse,
                              leading_dims=1 if batch else 0)
        want = np.asarray(fn(shard_column(
            jnp.asarray(fft_input(log_n, batch)), mesh)))
        for arrays, _ in groups[_ranks_of(size)]:
            np.testing.assert_array_equal(
                arrays[f"fft_{log_n}_{int(inverse)}_{batch}"], want)


# -- the sharded column operations --------------------------------------------

@pytest.mark.parametrize("size", [1, 2, 4])
def test_sharded_fold_line_matches_jax(groups, size):
    import jax.numpy as jnp

    from tstwo_tpu.fields import QM31
    from tstwo_tpu.ops import fri_ops
    from tstwo_tpu.ops import qm31 as qm31_ops

    vals, itw = fold_inputs()
    alpha = qm31_ops.scalar(QM31.from_u32_unchecked(1, 2, 3, 4))
    want = np.asarray(fri_ops.fold_line(jnp.asarray(vals), jnp.asarray(itw),
                                        alpha))
    for arrays, _ in groups[_ranks_of(size)]:
        np.testing.assert_array_equal(arrays["fold"], want)


@pytest.mark.parametrize("size", [1, 2, 4])
def test_sharded_quotients_match_jax(groups, size):
    import jax.numpy as jnp

    from tstwo_tpu.circle import SECURE_FIELD_CIRCLE_GEN, CanonicCoset
    from tstwo_tpu.fields import QM31
    from tstwo_tpu.pcs.quotients import (ColumnSampleBatch, PointSample,
                                         accumulate_quotients)

    domain = CanonicCoset.new(8).circle_domain()
    samples = [[PointSample(SECURE_FIELD_CIRCLE_GEN,
                            QM31.from_u32_unchecked(i + 1, 2, 3, 4))]
               for i in range(3)]
    want = accumulate_quotients(
        domain, [jnp.asarray(c) for c in quotient_columns()],
        QM31.from_u32_unchecked(9, 8, 7, 6),
        ColumnSampleBatch.new_vec(samples), 1)
    for arrays, _ in groups[_ranks_of(size)]:
        np.testing.assert_array_equal(arrays["quotients"],
                                      np.asarray(want.values))


@pytest.mark.parametrize("size", [1, 2, 4])
def test_sharded_leaf_layer_matches_jax(groups, size):
    import jax.numpy as jnp

    from tstwo_tpu.vcs.blake2s_merkle import commit_on_layer

    want = np.asarray(commit_on_layer(
        6, None, [jnp.asarray(c) for c in leaf_columns()]))
    for arrays, _ in groups[_ranks_of(size)]:
        np.testing.assert_array_equal(arrays["leaf"], want)


@pytest.mark.parametrize("size", [1, 2, 4])
def test_mesh_collectives_and_their_traffic(groups, size):
    for arrays, res in groups[_ranks_of(size)]:
        r = res["rank"]
        # row j of the result came from rank j, which sent its row r
        assert res["all_to_all"] == [[3 * r + c + 100 * j for c in range(3)]
                                     for j in range(size)]
        assert res["broadcast"] == size - 1 + 7
        t = res["traffic"]
        assert t["all_to_all"] == {
            "calls": 1, "bytes": 12 * (size - 1),
            "sizes": {str(12 * (size - 1)): 1}}
        sent = 4 * (size - 1) if r == size - 1 else 0
        assert t["broadcast"] == {"calls": 1, "bytes": sent,
                                  "sizes": {str(sent): 1}}


@pytest.mark.parametrize("size", [1, 2, 4])
def test_sharded_merkle_commit_and_decommit_match_jax(groups, size):
    import jax.numpy as jnp

    from tstwo_tpu.vcs import MerkleProver

    cols = [jnp.asarray(c) for c in merkle_columns()]
    tree = MerkleProver.commit(cols)
    queried, dec = tree.decommit(MERKLE_QUERIES, cols)
    want = {"root": tree.root().hex(), "sharded": True,
            "queried": [v.value for v in queried],
            "hash_witness": [h.hex() for h in dec.hash_witness],
            "column_witness": [v.value for v in dec.column_witness]}
    for _, res in groups[_ranks_of(size)]:
        assert res["merkle"] == want


def poseidon_tree_result(root, sharded, queried, dec):
    """A Poseidon252 tree's root and decommitment as JSON values."""
    return {"root": f"{root.value:064x}", "sharded": sharded,
            "queried": [v.value for v in queried],
            "hash_witness": [f"{h.value:064x}" for h in dec.hash_witness],
            "column_witness": [v.value for v in dec.column_witness]}


@pytest.fixture(scope="module")
def single_poseidon_tree():
    """The port's single-device Poseidon252 tree over `merkle_columns`."""
    from tstwo_tpu_torch.utils import to_torch_u32
    from tstwo_tpu_torch.vcs.poseidon252_merkle import \
        Poseidon252MerkleProver

    cols = [to_torch_u32(c) for c in merkle_columns()]
    tree = Poseidon252MerkleProver.commit(cols)
    return tree, cols


@pytest.mark.parametrize("size", [1, 2, 4])
def test_sharded_poseidon_tree_equals_the_single_device_tree(
        groups, single_poseidon_tree, size):
    tree, cols = single_poseidon_tree
    queried, dec = tree.decommit(MERKLE_QUERIES, cols)
    want = poseidon_tree_result(tree.root(), True, queried, dec)
    for _, res in groups[_ranks_of(size)]:
        assert res["poseidon_merkle"] == want


@pytest.mark.parametrize("flavor", ["blake2s", "poseidon252"])
@pytest.mark.parametrize("size", [2, 4])
def test_tree_top_takes_a_noncontiguous_subroot_view(single_poseidon_tree,
                                                     flavor, size):
    """The top k layers hashed from the gathered subroots as the sharded
    commit sees them ([D, 8, 1] -> a transposed [8, D] view) equal the
    single-device tree's."""
    import torch

    from tstwo_tpu_torch.parallel.merkle import _commit_top
    from tstwo_tpu_torch.vcs.ops import MERKLE_OPS
    from tstwo_tpu_torch.vcs.prover import MerkleProver

    if flavor == "poseidon252":
        tree, cols = single_poseidon_tree
    else:
        from tstwo_tpu_torch.utils import to_torch_u32

        cols = [to_torch_u32(c) for c in merkle_columns()]
        tree = MerkleProver.commit(cols)
    k = size.bit_length() - 1
    gathered = tree.layers[k].t().contiguous()[:, :, None]  # [D, 8, 1]
    view = gathered[:, :, 0].t()
    assert not view.is_contiguous()
    top = _commit_top(MERKLE_OPS[flavor], view, cols, MERKLE_LOGS, "cpu")
    assert len(top) == k
    for got, want in zip(top, tree.layers[:k]):
        assert torch.equal(got, want)


# -- the mesh prove -----------------------------------------------------------

def _check_proofs(ranks, key, want_json, size, verify):
    from tstwo_tpu_torch.serialize import proof_from_dict

    proofs = [res[key] for _, res in ranks]
    assert len(set(proofs)) == 1, "the ranks' proofs differ"
    assert proofs[0] == want_json
    verify(proof_from_dict(json.loads(proofs[0])))
    for _, res in ranks:
        rows = res[f"{key}_leaf_rows"]
        assert rows, "no sharded commit"
        for log, _, local in rows:
            assert local == (1 << log) // size, (log, local)


@pytest.mark.parametrize("group", ["d1", "d2", "d4", "2x2"])
def test_mesh_prove_wide_fibonacci_equals_the_jax_proof(groups, group):
    from tstwo_tpu_torch.examples.wide_fibonacci import (
        WideFibonacciEval, verify_wide_fibonacci)
    from tstwo_tpu_torch.constraint_framework import (FrameworkComponent,
                                                      TraceLocationAllocator)
    from tstwo_tpu_torch.fields import QM31
    from tstwo_tpu_torch.pcs import PcsConfig

    size = GROUPS[group][0]
    comp = FrameworkComponent(TraceLocationAllocator(),
                              WideFibonacciEval(8, 8), QM31.zero())
    with open(FIXTURE) as f:
        want = f.read().strip()
    _check_proofs(groups[group], "wide_fib", want, size,
                  lambda p: verify_wide_fibonacci(p, comp, PcsConfig(), 8))


@pytest.fixture(scope="module")
def jax_basic_air_json():
    from tstwo_tpu.examples.basic_air import prove_basic_air
    from tstwo_tpu.serialize import proof_to_dict

    proof, _, _ = prove_basic_air(log_num_rows=BASIC_AIR_LOG)
    return json.dumps(proof_to_dict(proof), sort_keys=True)


def test_mesh_prove_basic_air_equals_the_jax_single_device_proof(
        groups, jax_basic_air_json):
    from tstwo_tpu_torch.constraint_framework import (FrameworkComponent,
                                                      TraceLocationAllocator)
    from tstwo_tpu_torch.examples.basic_air import TestEval, verify_basic_air
    from tstwo_tpu_torch.fields import QM31
    from tstwo_tpu_torch.pcs import PcsConfig

    comp = FrameworkComponent(TraceLocationAllocator(),
                              TestEval(BASIC_AIR_LOG), QM31.zero())
    _check_proofs(groups["d4"], "basic_air", jax_basic_air_json, 4,
                  lambda p: verify_basic_air(p, comp, PcsConfig(),
                                             BASIC_AIR_LOG))


@pytest.mark.parametrize("group", ["d1", "d2", "d4", "2x2"])
def test_mesh_prove_poseidon252_equals_the_jax_proof(groups, group):
    """Every rank's Poseidon252 proof is the committed JAX proof field by
    field, and the port's verifier accepts it."""
    import pickle

    from test_torch_poseidon_prove import proof_fields
    from tstwo_tpu_torch.constraint_framework import (FrameworkComponent,
                                                      TraceLocationAllocator)
    from tstwo_tpu_torch.examples.basic_air import TestEval, verify_basic_air
    from tstwo_tpu_torch.fields import QM31
    from tstwo_tpu_torch.pcs import PcsConfig

    size = GROUPS[group][0]
    with open(POSEIDON_FIXTURE) as f:
        want = json.loads(f.read())
    comp = FrameworkComponent(TraceLocationAllocator(),
                              TestEval(POSEIDON_LOG), QM31.zero())
    for _, res in groups[group]:
        with open(res["poseidon_pickle"], "rb") as f:
            proof = pickle.load(f)
        assert proof_fields(proof) == want
        verify_basic_air(proof, comp, PcsConfig(), POSEIDON_LOG,
                         flavor="poseidon252")
        rows = res["poseidon_leaf_rows"]
        assert rows, "no sharded commit"
        for log, _, local in rows:
            assert local == (1 << log) // size, (log, local)


def test_jax_mesh_prove_poseidon252_is_the_fixture():
    """The JAX package's own mesh prove (4 of the conftest's virtual
    devices) gives the proof the port's ranks are held to."""
    from test_torch_poseidon_prove import proof_fields
    from tstwo_tpu.examples.basic_air import prove_basic_air
    from tstwo_tpu.parallel.mesh import make_mesh

    proof, _, _ = prove_basic_air(POSEIDON_LOG, flavor="poseidon252",
                                  mesh=make_mesh(4))
    with open(POSEIDON_FIXTURE) as f:
        assert proof_fields(proof) == json.loads(f.read())


def test_mesh_predicates_follow_the_jax_threshold():
    import torch

    from tstwo_tpu.parallel.fft import sharded_fft_applicable as jax_applies
    from tstwo_tpu.parallel.mesh import make_mesh as jax_mesh
    from tstwo_tpu_torch.parallel.fft import sharded_fft_applicable
    from tstwo_tpu_torch.parallel.mesh import Mesh

    for size in (1, 2, 4, 8):
        mesh = Mesh(None, 0, size, (1, size), torch.device("cpu"), "gloo")
        for log_n in range(0, 12):
            assert (sharded_fft_applicable(mesh, log_n)
                    == jax_applies(jax_mesh(size), log_n))
            assert mesh.shards(log_n) == (
                jax_applies(jax_mesh(size), log_n) and log_n >= 3)
    with pytest.raises(ValueError):
        Mesh(None, 0, 3, (1, 3), torch.device("cpu"), "gloo")


# -- mesh checkpoints ---------------------------------------------------------

def test_jax_mesh_checkpoint_finishes_in_the_port_at_two_ranks(
        tmp_path, jax_basic_air_json):
    from tstwo_tpu.channel.blake2s import Blake2sChannel
    from tstwo_tpu.circle import CanonicCoset
    from tstwo_tpu.examples.basic_air import generate_trace
    from tstwo_tpu.parallel.mesh import make_mesh
    from tstwo_tpu.pcs import PcsConfig
    from tstwo_tpu.pcs.prover import CommitmentSchemeProver
    from tstwo_tpu.poly.circle_poly import CircleEvaluation
    from tstwo_tpu.poly.twiddles import precompute_twiddles
    from tstwo_tpu.serialize import save_prover_checkpoint

    log = BASIC_AIR_LOG
    config = PcsConfig()
    domain = CanonicCoset.new(log).circle_domain()
    twiddles = precompute_twiddles(
        CanonicCoset.new(log + 2).circle_domain().half_coset)
    channel = Blake2sChannel()
    scheme = CommitmentSchemeProver(config, twiddles, mesh=make_mesh(8))
    tb = scheme.tree_builder()
    tb.extend_evals([])
    tb.commit(channel)
    channel.mix_u64(log)
    tb = scheme.tree_builder()
    tb.extend_evals([CircleEvaluation(domain, c)
                     for c in generate_trace(log)])
    tb.commit(channel)
    path = str(tmp_path / "jax_mesh.npz")
    save_prover_checkpoint(path, scheme, channel)

    ranks = finish_group(start_group(
        str(tmp_path / "ranks"), 2, ("checkpoint", "port_checkpoint"),
        extra=(path,)))
    for _, res in ranks:
        assert res["refused"], "a mesh checkpoint loaded without a mesh"
        assert res["sharded_evals"] > 0
        assert res["checkpoint"] == jax_basic_air_json

    # the port's own mesh checkpoint holds the whole arrays, as the JAX
    # package's does, and says it came from a mesh
    port = np.load(str(tmp_path / "ranks" / "port_mesh.npz"))
    ref = np.load(path)
    assert json.loads(str(port["__meta__"])) == json.loads(
        str(ref["__meta__"]))
    assert sorted(port.files) == sorted(ref.files)
    for name in port.files:
        if name != "__meta__":
            np.testing.assert_array_equal(port[name], ref[name])
    # utils.to_host gathers a sharded evaluation to the whole column
    for arrays, res in ranks:
        assert res["to_host_sharded"]
        np.testing.assert_array_equal(arrays["to_host"], ref["t1_e0"])


@pytest.fixture(scope="module")
def poseidon_checkpoint(tmp_path_factory):
    """A committed Poseidon252 scheme of the basic AIR at log 3, saved
    with a Blake2s channel state (neither package saves a Poseidon252
    channel: tests/test_torch_checkpoint.py); (path, scheme)."""
    from tstwo_tpu_torch.channel.blake2s import Blake2sChannel
    from tstwo_tpu_torch.channel.poseidon import Poseidon252Channel
    from tstwo_tpu_torch.circle import CanonicCoset
    from tstwo_tpu_torch.examples.basic_air import generate_trace
    from tstwo_tpu_torch.pcs import PcsConfig
    from tstwo_tpu_torch.pcs.prover import CommitmentSchemeProver
    from tstwo_tpu_torch.poly.circle_poly import CircleEvaluation
    from tstwo_tpu_torch.poly.twiddles import precompute_twiddles
    from tstwo_tpu_torch.serialize import save_prover_checkpoint
    from tstwo_tpu_torch.vcs.ops import Poseidon252MerkleOps

    log = 3
    twiddles = precompute_twiddles(
        CanonicCoset.new(log + 2).circle_domain().half_coset)
    scheme = CommitmentSchemeProver(PcsConfig(), twiddles, device="cpu",
                                    merkle_ops=Poseidon252MerkleOps)
    channel = Poseidon252Channel()
    for evals in ([], [CircleEvaluation(CanonicCoset.new(log).circle_domain(),
                                        c)
                       for c in generate_trace(log, device="cpu")]):
        tb = scheme.tree_builder()
        tb.extend_evals(evals)
        tb.commit(channel)
    path = str(tmp_path_factory.mktemp("poseidon_ckpt") / "ckpt.npz")
    save_prover_checkpoint(path, scheme, Blake2sChannel())
    return path, scheme, twiddles


@pytest.mark.parametrize("rank", [0, 1])
def test_poseidon252_checkpoint_loads_a_poseidon252_tree_under_a_mesh(
        poseidon_checkpoint, rank):
    """Rank `rank` of two rebuilds the sharded tree of the checkpoint's
    flavour: its root is the saved tree's felt, and its layers of log 1
    or more are the rank's slices of the saved layers (no collective)."""
    import torch

    from tstwo_tpu_torch.parallel.merkle import ShardedMerkleProver
    from tstwo_tpu_torch.parallel.mesh import Mesh
    from tstwo_tpu_torch.serialize import load_prover_checkpoint
    from tstwo_tpu_torch.vcs.ops import Poseidon252MerkleOps

    path, saved, twiddles = poseidon_checkpoint
    mesh = Mesh(None, rank, 2, (1, 2), torch.device("cpu"), "gloo")
    scheme, _ = load_prover_checkpoint(path, twiddles, mesh=mesh)
    assert scheme.merkle_ops is Poseidon252MerkleOps
    for got, want in zip(scheme.trees, saved.trees):
        tree = got.commitment
        assert isinstance(tree, ShardedMerkleProver)
        assert tree.merkle_ops is Poseidon252MerkleOps
        assert tree.root() == want.commitment.root()
        for log, (layer, whole) in enumerate(zip(tree.layers,
                                                 want.commitment.layers)):
            if tree.sharded and log >= mesh.log_size:
                start, stop = mesh.local_range(whole.shape[1])
                whole = whole[:, start:stop]
            assert torch.equal(layer, whole)
    assert scheme.trees[1].commitment.sharded


def test_mesh_refuses_what_it_cannot_run():
    """NCCL with more ranks on a host than it has cards, a mesh without an
    initialised process group, and an entry device that is not the
    mesh's all raise instead of running somewhere else."""
    import torch

    from tstwo_tpu_torch.parallel import mesh as pmesh
    from tstwo_tpu_torch.parallel.mesh import Mesh
    from tstwo_tpu_torch.utils import mesh_device

    with pytest.raises(ValueError, match="NCCL needs a card"):
        pmesh._device_for("nccl", 0, torch.cuda.device_count() + 1, None)
    if not torch.distributed.is_initialized():
        with pytest.raises(RuntimeError, match="not initialised"):
            pmesh.make_mesh()
    mesh = Mesh(None, 1, 2, (1, 2), torch.device("cpu"), "gloo")
    assert mesh_device(mesh) == torch.device("cpu")
    with pytest.raises(ValueError, match="the mesh runs on"):
        mesh_device(mesh, "cuda:1")
    assert mesh.local_range(16) == (8, 16)
    with pytest.raises(ValueError, match="does not hold"):
        Mesh(None, 0, 4, (2, 3), torch.device("cpu"), "gloo")
