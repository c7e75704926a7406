"""Kernel K2: the SMEM seed machine as one CUDA launch (counterpart of
seqlib_tpu/ops/fm_pallas.py).

``smem_machine_cuda`` launches ``csrc/smem_machine.cu``; it is what
``ops.fm.smem_machine`` runs on CUDA tensors (the plain version there,
``ops.fm._smem_machine``, runs on CPU tensors).  A narrow index (int32
blocks, 48-byte rows) takes the kernel's int32 instantiation, a wide one
(int64 blocks, 64-byte rows) its int64 instantiation, which returns
int64 interval starts; both count as launches of K2.  ``load_chase`` is
the latency probe behind K2's dependent-load bound.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_lib

KERNEL = "smem_machine"


def smem_machine_cuda(fm, reads, lens, x0, min_intv, active,
                      max_seeds: int, min_seed_len: int, C: int,
                      max_rounds: int, step_cap: int,
                      p3_seeds: int = 0, p3_max_intv: int = 20):
    """Launch kernel K2 on CUDA tensors (raises on anything else)."""
    dev = reads.device
    cuda_lib.on_device("smem_machine_cuda", dev, lens, x0, min_intv, active)
    guard = cuda_lib.on_device("smem_machine_cuda", dev, fm.blocks)
    B, L = reads.shape
    lib = cuda_lib.load(KERNEL)
    if not 1 <= C <= lib.smem_machine_max_stack():
        raise ValueError(f"smem_machine_cuda: stack depth C={C} not in "
                         f"1..{lib.smem_machine_max_stack()}")
    if L < 1 or max_seeds < 1:
        raise ValueError("smem_machine_cuda: empty read or seed width")
    width = {torch.int32: 12, torch.int64: 8}.get(fm.blocks.dtype)
    if not fm.blocks.is_contiguous() or fm.blocks.dim() != 2 \
            or fm.blocks.shape[1] != width:
        raise ValueError("smem_machine_cuda: blocks must be contiguous "
                         "int32 [rows, 12] or int64 [rows, 8]")
    wide = fm.blocks.dtype == torch.int64
    i32 = torch.int32
    rk = torch.int64 if wide else i32

    def lane(v, dt):
        v = torch.as_tensor(v, device=dev)
        if v.shape != (B,):
            raise ValueError(f"smem_machine_cuda: per-lane input of shape "
                             f"{tuple(v.shape)}, expected ({B},)")
        return v.to(dt).contiguous()

    reads_u8 = reads.to(torch.uint8).contiguous()
    lens32 = lane(lens, i32)
    x032 = lane(x0, i32)
    mi32 = lane(min_intv, i32)
    act = lane(active, torch.uint8)
    S, P3 = max_seeds, p3_seeds
    qb = torch.empty((B, S), dtype=i32, device=dev)
    qe, isz = torch.empty_like(qb), torch.empty_like(qb)
    il = torch.empty((B, S), dtype=rk, device=dev)
    n_seeds = torch.empty(B, dtype=i32, device=dev)
    n_drop = torch.empty_like(n_seeds)
    pshape = (B, max(P3, 1))
    pqb = torch.empty(pshape, dtype=i32, device=dev)
    pqe, pisz = torch.empty_like(pqb), torch.empty_like(pqb)
    pil = torch.empty(pshape, dtype=rk, device=dev)
    pn = torch.empty(B, dtype=i32, device=dev)
    ct = ctypes.c_longlong if wide else ctypes.c_int
    L2 = (ct * 5)(*fm.L2_host)
    vp = ctypes.c_void_p
    ci = ctypes.c_int
    entry = lib.smem_machine_wide if wide else lib.smem_machine
    with guard:
        rc = entry(
            vp(fm.blocks.data_ptr()), vp(reads_u8.data_ptr()),
            vp(lens32.data_ptr()), vp(x032.data_ptr()), vp(mi32.data_ptr()),
            vp(act.data_ptr()), ci(B), ci(L), ct(fm.primary), L2, ci(S),
            ci(C), ci(min_seed_len), ci(max_rounds), ci(step_cap), ci(P3),
            ci(p3_max_intv), vp(qb.data_ptr()), vp(qe.data_ptr()),
            vp(il.data_ptr()), vp(isz.data_ptr()), vp(n_seeds.data_ptr()),
            vp(n_drop.data_ptr()), vp(pqb.data_ptr()), vp(pqe.data_ptr()),
            vp(pil.data_ptr()), vp(pisz.data_ptr()), vp(pn.data_ptr()),
            cuda_lib.stream_ptr(dev))
    cuda_lib.check(rc, KERNEL)
    cuda_lib.bump(cuda_lib.LAUNCHES, KERNEL)
    out = dict(qbeg=qb, qend=qe, intv_l=il, intv_sz=isz, n_seeds=n_seeds,
               n_dropped=n_drop)
    if P3:
        out.update(p3_qbeg=pqb, p3_qend=pqe, p3_intv_l=pil,
                   p3_intv_sz=pisz, p3_n=pn)
    return out


def load_chase(table: torch.Tensor, n: int, out: torch.Tensor) -> None:
    """Follow ``n`` dependent loads from row 0 of the int32 CUDA tensor
    ``table`` [rows, W] (word 0 of row r holds the next row) in one
    thread, with K2's load path; the last row reached goes to ``out[0]``.
    A latency probe, not a kernel of the alignment path: it does not
    count as a K2 launch."""
    guard = cuda_lib.on_device("load_chase", table.device, out)
    if table.dim() != 2 or not table.is_contiguous() \
            or table.dtype != torch.int32:
        raise ValueError("load_chase: contiguous int32 [rows, W] CUDA table "
                         "and an out tensor on the same device")
    lib = cuda_lib.load(KERNEL)
    with guard:
        rc = lib.smem_load_chase(
            ctypes.c_void_p(table.data_ptr()), ctypes.c_int(table.shape[1]),
            ctypes.c_int(n), ctypes.c_void_p(out.data_ptr()),
            cuda_lib.stream_ptr(table.device))
    cuda_lib.check(rc, "smem_load_chase")
