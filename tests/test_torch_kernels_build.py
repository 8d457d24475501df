"""tstwo_tpu_torch.kernels.build() with a stand-in nvcc (runs on the CPU).

The stand-in writes its `-o` file, or fails on the source named in
FAKE_NVCC_FAIL; with FAKE_NVCC_HANG set, a source that compiles then
records its pid there and sleeps.  The tests show what build() leaves
behind: the library on success, and no object file and no running
compiler when one compile fails.
"""
from __future__ import annotations

import os
import stat
import time

import pytest

from tstwo_tpu_torch import kernels

FAKE_NVCC = """#!/bin/sh
out=""; prev=""; last=""
for a in "$@"; do
  [ "$prev" = "-o" ] && out="$a"
  prev="$a"; last="$a"
done
case "$last" in
  *.cu)
    if [ -n "$FAKE_NVCC_FAIL" ] && [ "${last##*/}" = "$FAKE_NVCC_FAIL" ]; then
      echo "error: cannot compile $last" >&2; exit 2
    fi
    echo "ptxas info: compiled ${last##*/}" >&2
    : > "$out"
    if [ -n "$FAKE_NVCC_HANG" ]; then
      echo $$ >> "$FAKE_NVCC_HANG"; exec sleep 60
    fi;;
  *) : > "$out";;
esac
"""


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.delenv("FAKE_NVCC_FAIL", raising=False)
    monkeypatch.delenv("FAKE_NVCC_HANG", raising=False)
    monkeypatch.setattr(kernels, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(kernels, "BUILD_INFO", {})
    return tmp_path


def _out_dir(root):
    return root / "build" / kernels._source_hash()


def test_build_links_every_source_and_leaves_only_the_library(fake_nvcc):
    lib_path = kernels.build()
    assert lib_path == _out_dir(fake_nvcc) / kernels.LIB_NAME
    assert sorted(p.name for p in lib_path.parent.iterdir()) == [
        kernels.LIB_NAME]
    info = kernels.BUILD_INFO
    assert info["cached"] is False
    assert [line.split()[-1] for line in info["ptxas"].splitlines()] == list(
        kernels.SOURCES)
    assert kernels.build() == lib_path
    assert kernels.BUILD_INFO["cached"] is True


def test_failed_compile_kills_the_others_and_removes_objects(
        fake_nvcc, monkeypatch):
    pids = fake_nvcc / "pids"
    monkeypatch.setenv("FAKE_NVCC_FAIL", kernels.SOURCES[0])
    monkeypatch.setenv("FAKE_NVCC_HANG", str(pids))
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError,
                       match=f"nvcc failed on {kernels.SOURCES[0]}"):
        kernels.build()
    assert time.perf_counter() - t0 < 30  # the others sleep 60 s
    assert list(_out_dir(fake_nvcc).iterdir()) == []
    for pid in pids.read_text().split() if pids.exists() else []:
        with pytest.raises(ProcessLookupError):
            os.kill(int(pid), 0)


def test_failed_last_compile_removes_the_objects_built_before_it(
        fake_nvcc, monkeypatch):
    monkeypatch.setenv("FAKE_NVCC_FAIL", kernels.SOURCES[-1])
    with pytest.raises(RuntimeError,
                       match=f"nvcc failed on {kernels.SOURCES[-1]}"):
        kernels.build()
    assert list(_out_dir(fake_nvcc).iterdir()) == []


@pytest.fixture
def fake_entry(monkeypatch):
    """A stand-in C entry point `tstwo_probe`, device 0 current, stream 7."""
    import torch

    calls = []

    def probe(*args):
        calls.append(args)
        return probe.err

    probe.err = 0
    monkeypatch.setitem(kernels._entries, "probe", probe)
    monkeypatch.setitem(kernels.LAUNCHES, "probe", 0)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(kernels, "_current_stream", lambda index: 7)
    monkeypatch.setattr(kernels, "lib", lambda: pytest.fail(
        "launch looked the library up again"))
    return probe, calls


def test_launch_calls_the_cached_entry_on_the_current_stream(fake_entry):
    import torch

    probe, calls = fake_entry
    kernels.launch("probe", "probe", torch.device("cuda", 0), 11, 22)
    kernels.launch("probe", "probe", torch.device("cuda"), 33)
    assert calls == [(11, 22, 7), (33, 7)]
    assert kernels.LAUNCHES["probe"] == 2


def test_launch_raises_and_counts_nothing_when_the_launch_failed(fake_entry):
    import torch

    probe, calls = fake_entry
    probe.err = 9
    with pytest.raises(RuntimeError, match="probe kernel launch failed"):
        kernels.launch("probe", "probe", torch.device("cuda", 0), 1)
    assert kernels.LAUNCHES["probe"] == 0


def test_segment_table_takes_rows_where_they_lie():
    """The table both Merkle layer wrappers hand to their kernels: [n] and
    [C, n] entries in order, strided rows as they are, empty stacks
    skipped, more than MAX_SEGMENTS entries concatenated into one."""
    import torch

    cpu = torch.device("cpu")
    wide = torch.arange(40, dtype=torch.int32).reshape(4, 10)
    entries = [wide[0, :8], wide[1:3, 2:10], wide[:0, :8], wide[::2, 1:9]]
    table = kernels.segment_table(entries, 8, cpu)
    ptrs, strides, rows, count = table.args
    assert (count, table.rows) == (3, 5)
    assert list(rows)[:3] == [1, 2, 2] and list(strides)[1:3] == [10, 20]
    assert list(ptrs)[:3] == [wide.data_ptr(), wide[1, 2:].data_ptr(),
                              wide[0, 1:].data_ptr()]
    many = kernels.segment_table([wide[0, :8]] * 17, 8, cpu)
    assert many.args[3] == 1 and many.rows == 17
    assert torch.equal(many.segments[0], wide[0, :8].expand(17, 8))
    assert kernels.segment_table([], 8, cpu).args == (None, None, None, 0)
    strided = kernels.segment_table([wide[:, ::2][:, :4]], 4, cpu)
    assert strided.segments[0].stride(1) == 1  # copied: the kernel reads rows


def test_segment_table_refuses_what_a_kernel_does_not_take():
    import torch

    cpu = torch.device("cpu")
    x = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="expected \\[4\\]"):
        kernels.segment_table([x], 4, cpu)
    with pytest.raises(ValueError, match="column entry"):
        kernels.segment_table([x[None]], 8, cpu)
    with pytest.raises(TypeError, match="int32"):
        kernels.segment_table([x.to(torch.int64)], 8, cpu)
    with pytest.raises(TypeError, match="on cuda"):
        kernels.segment_table([x], 8, torch.device("cuda", 0))
