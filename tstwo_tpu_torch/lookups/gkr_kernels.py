"""The GKR sum-check's hypercube work: a layer oracle's two round sums and
the fold of an MLE's first variable.

`round_sums` and `fold` launch csrc/gkr.cu for CUDA tensors (`gkr_round_sums`,
one launch an oracle a round; `mle_fold`, one an MLE a round) and take
their plain PyTorch versions (`round_sums_plain`, `fold_plain`) for CPU
tensors.  They replace the jitted tstwo_tpu/lookups/gkr.py:311, 331, 363
`_eval_*_sum_kernel` and tstwo_tpu/lookups/mle.py:27
`_fold_first_variable`.

Round sums (reference backend/cpu/lookups/gkr.ts:185-220): eq_arr is
[4, n_terms]; a layer column is [4, 4 n_terms] (a LogUpMultiplicities
layer's numerators [4 n_terms] base values): rows r0 = first half, r1 =
second half, each split into even/odd pairs (i0, i1); the polynomial's
value at 2 is r2 = 2 r1 - r0.  The result is the sums at 0 and at 2 as
int32 [8], which come to the host in one transfer, the protocol's one sync
a sum-check round.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from .. import kernels
from ..fields import QM31
from ..ops import m31, qm31
from ..tracing import count

GRAND_PRODUCT = "GrandProduct"
LOGUP_GENERIC = "LogUpGeneric"
LOGUP_MULTIPLICITIES = "LogUpMultiplicities"
LOGUP_SINGLES = "LogUpSingles"
# the kernel's template of each layer kind (csrc/gkr.cu)
KINDS = {GRAND_PRODUCT: 0, LOGUP_GENERIC: 1, LOGUP_MULTIPLICITIES: 2,
         LOGUP_SINGLES: 3}


# -- plain versions -----------------------------------------------------------

def _split(arr: torch.Tensor, n_terms: int):
    """(r0i0, r0i1, r1i0, r1i1) of a [..., 4 n_terms] layer column."""
    return (arr[..., 0: 2 * n_terms: 2], arr[..., 1: 2 * n_terms: 2],
            arr[..., 2 * n_terms:: 2], arr[..., 2 * n_terms + 1:: 2])


def _at_two(r0: torch.Tensor, r1: torch.Tensor) -> torch.Tensor:
    return m31.sub(m31.add(r1, r1), r0)


def _sum(x: torch.Tensor) -> torch.Tensor:
    """Modular sum over the point axis -> int32 [4]: an int64 sum of fewer
    than 2^32 canonical values cannot overflow, then one `% P`."""
    return m31.narrow(x.to(torch.int64).sum(dim=1) % m31.P)


def round_sums_plain(kind: str, eq_arr: torch.Tensor,
                     cols: Sequence[torch.Tensor], lam: QM31) -> torch.Tensor:
    """The two round sums of an oracle of `kind` as int32 [8] (at 0, then
    at 2), in plain PyTorch: `cols` is (values,) for a GrandProduct layer,
    (numerators, denominators) for LogUpGeneric and LogUpMultiplicities,
    (denominators,) for LogUpSingles."""
    n_terms = eq_arr.shape[1]
    lam_arr = qm31.scalar(lam, (1,), eq_arr.device)

    if kind == GRAND_PRODUCT:
        r0i0, r0i1, r1i0, r1i1 = _split(cols[0], n_terms)
        t0 = qm31.mul(r0i0, r0i1)
        t2 = qm31.mul(_at_two(r0i0, r1i0), _at_two(r0i1, r1i1))
    elif kind == LOGUP_SINGLES:
        d0, d1, d0b, d1b = _split(cols[0], n_terms)

        def recip_acc(da, db):
            return qm31.add(qm31.add(da, db),
                            qm31.mul(lam_arr, qm31.mul(da, db)))

        t0 = recip_acc(d0, d1)
        t2 = recip_acc(_at_two(d0, d0b), _at_two(d1, d1b))
    else:
        nums, dens = cols
        if kind == LOGUP_MULTIPLICITIES:
            nums = qm31.from_m31(nums)
        n0, n1, n0b, n1b = _split(nums, n_terms)
        d0, d1, d0b, d1b = _split(dens, n_terms)

        def frac_acc(na, da, nb, db):
            numer = qm31.add(qm31.mul(na, db), qm31.mul(nb, da))
            return qm31.add(numer, qm31.mul(lam_arr, qm31.mul(da, db)))

        t0 = frac_acc(n0, d0, n1, d1)
        t2 = frac_acc(_at_two(n0, n0b), _at_two(d0, d0b),
                      _at_two(n1, n1b), _at_two(d1, d1b))
    return torch.cat([_sum(qm31.mul(eq_arr, t0)), _sum(qm31.mul(eq_arr, t2))])


def fold_plain(arr: torch.Tensor, c: QM31) -> torch.Tensor:
    """lhs + c (rhs - lhs) over the halves of a [4, n] QM31 MLE, or of an
    [n] base-field one (zero-extended), as a [4, n / 2] tensor."""
    if arr.dim() == 1:
        arr = qm31.from_m31(arr)
    mid = arr.shape[1] // 2
    lhs, rhs = arr[:, :mid], arr[:, mid:]
    c_arr = qm31.scalar(c, (1,), arr.device)
    return qm31.add(qm31.mul(c_arr, qm31.sub(rhs, lhs)), lhs)


# -- the kernels ----------------------------------------------------------------

def _rows(t: torch.Tensor, name: str, n: int) -> torch.Tensor:
    """A [4, n] QM31 tensor whose rows the kernel reads a stride apart
    (copied when its points do not lie next to each other)."""
    kernels.check_cuda_tensor(t, name, contiguous=False)
    if t.dim() != 2 or t.shape[0] != 4 or t.shape[1] != n:
        raise ValueError(f"{name}: expected [4, {n}], got {tuple(t.shape)}")
    return t if n == 1 or t.stride(1) == 1 else t.contiguous()


def _base(t: torch.Tensor, name: str, n: int) -> torch.Tensor:
    """An [n] base-field tensor, contiguous."""
    kernels.check_cuda_tensor(t, name, contiguous=False)
    if t.shape != (n,):
        raise ValueError(f"{name}: expected [{n}], got {tuple(t.shape)}")
    return t.contiguous()


def _check_kind(kind: str, cols: Sequence[torch.Tensor]) -> None:
    if kind not in KINDS:
        raise ValueError(f"unknown layer kind {kind}")
    want = 2 if kind in (LOGUP_GENERIC, LOGUP_MULTIPLICITIES) else 1
    if len(cols) != want:
        raise ValueError(f"{kind}: expected {want} column(s), got "
                         f"{len(cols)}")


def round_sums_cuda(kind: str, eq_arr: torch.Tensor,
                    cols: Sequence[torch.Tensor], lam: QM31) -> torch.Tensor:
    """Launch csrc/gkr.cu `gkr_round_sums` on CUDA tensors: the eq prefix
    and the layer read where they lie, lambda by value; int32 [8]."""
    _check_kind(kind, cols)
    n_terms = eq_arr.shape[1] if eq_arr.dim() == 2 else 0
    if n_terms < 1:
        raise ValueError(f"eq_arr: expected [4, n_terms >= 1], got "
                         f"{tuple(eq_arr.shape)}")
    eq_arr = _rows(eq_arr, "eq_arr", n_terms)
    device = eq_arr.device
    if kind == LOGUP_MULTIPLICITIES:
        a = _base(cols[0], "numerators", 4 * n_terms)
        b = _rows(cols[1], "denominators", 4 * n_terms)
    elif kind == LOGUP_GENERIC:
        a = _rows(cols[0], "numerators", 4 * n_terms)
        b = _rows(cols[1], "denominators", 4 * n_terms)
    elif kind == GRAND_PRODUCT:
        a, b = _rows(cols[0], "values", 4 * n_terms), None
    else:
        a, b = None, _rows(cols[0], "denominators", 4 * n_terms)
    for t in (a, b):
        if t is not None and t.device != device:
            raise ValueError(f"a layer column is on {t.device}, eq_arr on "
                             f"{device}")
    out = torch.empty(8, dtype=torch.int32, device=device)
    kernels.launch(
        "gkr_round_sums", "gkr_round_sums", device, KINDS[kind],
        eq_arr.data_ptr(), eq_arr.stride(0),
        None if a is None else a.data_ptr(),
        0 if a is None else a.stride(0),
        None if b is None else b.data_ptr(),
        0 if b is None else b.stride(0), n_terms, *lam.to_ints(),
        out.data_ptr())
    return out


def fold_cuda(arr: torch.Tensor, c: QM31) -> torch.Tensor:
    """Launch csrc/gkr.cu `mle_fold` on a CUDA [4, n] QM31 MLE (rows read
    a stride apart) or [n] base-field MLE, n even; a fresh [4, n / 2]."""
    base = arr.dim() == 1
    n = arr.shape[-1]
    if n < 2 or n % 2:
        raise ValueError(f"expected an even number of points >= 2, got "
                         f"{tuple(arr.shape)}")
    arr = _base(arr, "arr", n) if base else _rows(arr, "arr", n)
    out = torch.empty((4, n // 2), dtype=torch.int32, device=arr.device)
    kernels.launch("mle_fold", "mle_fold", arr.device, arr.data_ptr(),
                   0 if base else arr.stride(0), n // 2, int(base),
                   *c.to_ints(), out.data_ptr())
    return out


# -- dispatch -----------------------------------------------------------------

def round_sums(kind: str, eq_arr: torch.Tensor, cols: Sequence[torch.Tensor],
               lam: QM31) -> Tuple[QM31, QM31]:
    """The round sums at 0 and at 2 of an oracle of `kind` on the host: the
    kernel for CUDA tensors (counted as `gkr_round_sums_on_card` in the
    span tree), the plain version for CPU ones."""
    if kernels.on_cuda(eq_arr):
        sums = round_sums_cuda(kind, eq_arr, cols, lam)
        count("gkr_round_sums_on_card", 1)
    else:
        sums = round_sums_plain(kind, eq_arr, cols, lam)
    sums = sums.tolist()
    return QM31.from_ints(sums[:4]), QM31.from_ints(sums[4:])


def fold(arr: torch.Tensor, c: QM31) -> torch.Tensor:
    """An MLE's first variable fixed to c: [4, n] or [n] -> [4, n / 2]."""
    if kernels.on_cuda(arr):
        return fold_cuda(arr, c)
    return fold_plain(arr, c)
