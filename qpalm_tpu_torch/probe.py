"""Memory-plan probes of K1's streaming tier (counterpart of the two Pallas
probes of scripts/probe_mosaic_scratch.py, :42-93 and :106-175).

    scratch_probe(seed, n)   seed (B,) -> (B, n): an (n, n) scratch per
                             problem, kept on chip (its rows dealt to
                             blocks, scratch_rows(n) a block, in shared
                             memory), filled with seed + row, 8 rank-1
                             updates M -= v v' (v = iota / n) made a pass
                             each, M's row sums out
    assembly_probe(A, w)     A (B, m, n), w (B, m) -> (B, n): the upper
                             triangle of M = A' diag(w) A by the streaming
                             tier's own Schur assembly (A in row panels
                             through shared memory) into a global scratch,
                             the row sums of its symmetric completion out

The CUDA source is csrc/probe_stream.cu; the plain versions below are what
a CPU tensor runs.  `measure` times both kernels at one shape and reports
the bytes their plan moves through its scratch per second;
`against_plain` holds them against their plain versions and times two
library yardsticks of the assembly.  Run on the card:

    python -m qpalm_tpu_torch.probe    one JSON line, n in 128, 224, 256,
                                       352 with m = 1.5 n and B = 128
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ._build import check_launch, kernels
from .linalg.chol import SMEM_LIMIT

SIZES = (128, 224, 256, 352)
BATCH = 128
RANK1_UPDATES = 8
# the scratch probe's rows of M a block (csrc/probe_stream.cu)
SCRATCH_ROWS = 32


def scratch_rows(n: int) -> int:
    """Rows of a problem's M a block of the scratch probe holds in shared
    memory beside the row of k / n (csrc/probe_stream.cu, scratch_rows):
    SCRATCH_ROWS, fewer where they would not fit SMEM_LIMIT; 0 where not
    even one row fits, an n the kernel refuses."""
    return min(SCRATCH_ROWS, SMEM_LIMIT // (4 * max(n, 1)) - 1)


def scratch_probe_plain(seed: torch.Tensor, n: int) -> torch.Tensor:
    """The scratch probe's result by plain tensor operations (float32)."""
    v = torch.arange(n, dtype=torch.float32, device=seed.device) / n
    M = (seed[:, None, None]
         + torch.arange(n, dtype=torch.float32, device=seed.device)[:, None]
         ).expand(-1, n, n)
    for _ in range(RANK1_UPDATES):
        M = M - v[:, None] * v[None, :]
    return M.sum(-1)


def assembly_probe_plain(A: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """M = A' diag(w) A formed by plain tensor operations, then its row
    sums."""
    return (A.transpose(1, 2) @ (w[..., None] * A)).sum(-1)


def assembly_probe_library(A: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The same row sums in one PyTorch call, which may contract A'(w (A 1))
    without forming M: a yardstick for the kernel, used nowhere else."""
    return torch.einsum("bmi,bm,bmj->bi", A, w, A)


def assembly_form_library(A: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The one PyTorch call that forms M = A' diag(w) A itself (both
    triangles): the second yardstick, used nowhere else."""
    return torch.einsum("bmi,bm,bmj->bij", A, w, A)


def _cuda_f32(name, *tensors):
    for t in tensors:
        if t.dtype != torch.float32 or not t.is_cuda:
            raise ValueError(f"{name}: every input must be a CUDA float32 "
                             f"tensor, got {t.dtype} on {t.device}")


def scratch_probe(seed: torch.Tensor, n: int) -> torch.Tensor:
    """The scratch probe: its kernel for a CUDA tensor, else the plain
    version.  `scratch_probe.launches` counts kernel launches.  The kernel
    takes n while one row of M and the row of k / n fit a block's shared
    memory (n <= 29056) and raises past it."""
    if seed.device.type == "cpu":
        return scratch_probe_plain(seed, n)
    _cuda_f32("scratch_probe", seed)
    if scratch_rows(n) < 1:
        raise ValueError(f"scratch_probe: a row of n={n} floats does not "
                         f"fit {SMEM_LIMIT} bytes of shared memory")
    seed = seed.contiguous()
    B = seed.shape[0]
    out = torch.empty((B, n), dtype=torch.float32, device=seed.device)
    with torch.cuda.device(seed.device):
        rc = kernels().qp_scratch_probe(
            seed.data_ptr(), out.data_ptr(), B, n,
            torch.cuda.current_stream().cuda_stream)
    check_launch("qp_scratch_probe", rc)
    scratch_probe.launches += 1
    return out


scratch_probe.launches = 0


def assembly_probe(A: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The assembly probe: its kernel for CUDA tensors, else the plain
    version.  `assembly_probe.launches` counts kernel launches."""
    if A.device.type == "cpu":
        return assembly_probe_plain(A, w)
    _cuda_f32("assembly_probe", A, w)
    B, m, n = A.shape
    if tuple(w.shape) != (B, m) or n % 4:
        raise ValueError(f"assembly_probe: A {tuple(A.shape)} and w "
                         f"{tuple(w.shape)}; n must be a multiple of 4")
    A = A.contiguous()
    A = A if A.data_ptr() % 16 == 0 else A.clone()
    w = w.contiguous()
    M = torch.empty((B, n, n), dtype=torch.float32, device=A.device)
    out = torch.empty((B, n), dtype=torch.float32, device=A.device)
    with torch.cuda.device(A.device):
        rc = kernels().qp_assembly_probe(
            A.data_ptr(), w.data_ptr(), M.data_ptr(), out.data_ptr(), B, n,
            m, torch.cuda.current_stream().cuda_stream)
    check_launch("qp_assembly_probe", rc)
    assembly_probe.launches += 1
    return out


assembly_probe.launches = 0


def probe_inputs(n: int, m: int, B: int = BATCH, seed: int = 0,
                 device="cuda"):
    """(seed (B,), A (B, m, n), w (B, m)) from a numpy generator, as the
    reference script makes them (uniform seed, normal A, w in [0.5, 1.5))."""
    rng = np.random.default_rng(seed)
    s = rng.random(B).astype(np.float32)
    A = rng.standard_normal((B, m, n)).astype(np.float32)
    w = (rng.random((B, m)) + 0.5).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device) for a in (s, A, w))


def assembly_passes(n: int) -> int:
    """Passes of the streaming assembly over A: one per 256 of the 8x8
    tiles of M's upper triangle (csrc/stream.cuh:schur_stream)."""
    nb = -(-n // 8)
    return -(-(nb * (nb + 1) // 2) // 256)


def plan_bytes(n: int, m: int, B: int = BATCH) -> dict:
    """Bytes each probe's plan moves through its scratch: the scratch probe
    writes M, reads and writes it in each rank-1 update and reads it for
    the row sums, all in shared memory; the assembly probe reads w once
    and A once a pass from global memory, writes the upper 8x8 tiles of M
    there and reads n^2 entries back for the row sums of the
    completion."""
    nb = -(-n // 8)
    return dict(scratch=4 * B * n * n * (2 + 2 * RANK1_UPDATES),
                assembly=4 * B * (assembly_passes(n) * m * n + m
                                  + 32 * nb * (nb + 1) + n * n + n))


def _relerr(got, want):
    return ((got.double() - want.double()).abs().max()
            / want.double().abs().max().clamp(min=1.0)).item()


def _ms(fn, reps):
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def measure(n: int, m: int, B: int = BATCH, reps: int = 5) -> dict:
    """Both probe kernels at (n, m, B) on the card: each one's mean time
    over `reps` launches after a warm-up, and its plan's bytes per
    second."""
    seed, A, w = probe_inputs(n, m, B)
    t_s = _ms(lambda: scratch_probe(seed, n), reps)
    t_a = _ms(lambda: assembly_probe(A, w), reps)
    nbytes = plan_bytes(n, m, B)
    return dict(n=n, m=m, B=B,
                scratch=dict(ms=t_s, GBps=nbytes["scratch"] / t_s / 1e6),
                assembly=dict(ms=t_a, GBps=nbytes["assembly"] / t_a / 1e6))


def against_plain(n: int, m: int, B: int = BATCH) -> dict:
    """Each probe kernel against its plain version on the same inputs: the
    relative error (to max(1, max|plain|), as the reference script) and the
    largest absolute one, the plain version's time, and for the assembly
    probe the times of the one library call that forms M as the kernel
    does (library_ms) and of the one that returns the same row sums, which
    may skip forming M and so does less work (row_sums_ms)."""
    seed, A, w = probe_inputs(n, m, B)
    got_s, got_a = scratch_probe(seed, n), assembly_probe(A, w)
    want_s = scratch_probe_plain(seed, n)
    want_a = assembly_probe_plain(A, w)
    return dict(
        scratch=dict(rel_err=_relerr(got_s, want_s),
                     max_abs_err=(got_s - want_s).abs().max().item(),
                     plain_ms=_ms(lambda: scratch_probe_plain(seed, n), 3)),
        assembly=dict(rel_err=_relerr(got_a, want_a),
                      max_abs_err=(got_a - want_a).abs().max().item(),
                      plain_ms=_ms(lambda: assembly_probe_plain(A, w), 3),
                      library_ms=_ms(lambda: assembly_form_library(A, w),
                                     5),
                      row_sums_ms=_ms(lambda: assembly_probe_library(A, w),
                                      5)))


def main():
    if not torch.cuda.is_available():
        raise SystemExit("the probes measure the card: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = []
    for n in SIZES:
        row = measure(n, n * 3 // 2)
        for name, part in against_plain(n, n * 3 // 2).items():
            row[name].update(part)
        rows.append(row)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "probes": rows}))


if __name__ == "__main__":
    main()
