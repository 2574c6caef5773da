"""IoU of convex quads: kernel and plain twin.

``quad_iou_gather`` (IoU of quads[ia[p]] with quads[ib[p]] for the pairs
below a live count, 0 past it) is what the device LANMS calls; with a (B,)
count the P pairs are B pages of P / B slots each, and slot p is live when
p mod (P / B) < n_live[p div (P / B)];
``quad_iou_pairs`` (IoU of q1[p] with q2[p]) is the same clip on paired
inputs, and ``quad_iou_matrix`` (all pairs of two sets) the counterpart of the
TPU kernel's matrix layout. On CUDA tensors all three launch ``csrc/quad_iou.cu``
(the counterpart of ``manuscript_tpu/ops/pallas_iou.py``); on CPU tensors
they run the plain torch version below, which is the same Sutherland–Hodgman
clip as ``manuscript_tpu/ops/lanms_jax.quad_iou_pairs``. Any other device,
or a CUDA tensor the kernel does not take, raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

SLOTS = 8  # most vertices quad ∩ quad can have under S-H clipping
launches = 0  # kernel launches (gather, pairs and matrix), for proof of the route
# a list while utils.profiling.count_flops runs: each launch's (pairs, live
# count tensor or None), read by call_flops once the block has ended
flop_calls = None
OPS_PER_PAIR = 860  # floating-point operations of one clip and its two areas


def _clip(polys, counts, a, b):
    """Clip repetition-padded polygons (P, 8, 2) against the half-plane left
    of a→b (P, 2). Emits past slot 8 are dropped; counts keep running."""
    p = polys.shape[0]
    prev = torch.roll(polys, 1, dims=1)
    ab = b - a

    def side(pts):
        return ab[:, None, 0] * (pts[..., 1] - a[:, None, 1]) - ab[:, None, 1] * (
            pts[..., 0] - a[:, None, 0]
        )

    curr_in = side(polys) >= 0
    prev_in = side(prev) >= 0
    is_dup = torch.all(polys == prev, dim=-1)

    d1 = polys - prev
    denom = d1[..., 0] * ab[:, None, 1] - d1[..., 1] * ab[:, None, 0]
    ca = a[:, None, :] - prev
    t = (ca[..., 0] * ab[:, None, 1] - ca[..., 1] * ab[:, None, 0]) / torch.where(
        denom == 0, torch.ones_like(denom), denom
    )
    inter = prev + t[..., None] * d1
    inter = torch.where((denom == 0)[..., None], prev, inter)

    emit_inter = (curr_in ^ prev_in) & ~is_dup
    emit_curr = curr_in & ~is_dup
    emits = torch.stack([inter, polys], dim=2).reshape(p, 2 * SLOTS, 2)
    emask = torch.stack([emit_inter, emit_curr], dim=2).reshape(p, 2 * SLOTS)
    pos = torch.cumsum(emask.to(torch.int64), dim=1) - 1
    target = torch.where(emask & (pos < SLOTS), pos, SLOTS)
    new = torch.zeros(p, SLOTS + 1, 2, dtype=polys.dtype, device=polys.device)
    new.scatter_(1, target[..., None].expand(p, 2 * SLOTS, 2), emits)
    new = new[:, :SLOTS]
    new_counts = emask.sum(dim=1)

    slot = torch.arange(SLOTS, device=polys.device)[None, :]
    live = slot < new_counts[:, None]
    is_last = slot == (new_counts - 1)[:, None]
    last_v = torch.where(is_last[..., None], new, torch.zeros_like(new)).sum(
        dim=1, keepdim=True
    )
    return torch.where(live[..., None], new, last_v), new_counts


def _area(polys):
    """Shoelace area of closed polygons (P, n, 2)."""
    nxt = torch.roll(polys, -1, dims=1)
    cross = polys[..., 0] * nxt[..., 1] - nxt[..., 0] * polys[..., 1]
    return torch.abs(cross.sum(dim=1)) / 2.0


def quad_iou_pairs_plain(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """IoU of paired quads: q1, q2 (P, 4, 2) → (P,)."""
    polys = torch.cat([q1, q1[:, 3:4].expand(-1, SLOTS - 4, 2)], dim=1)
    counts = torch.full((q1.shape[0],), 4, dtype=torch.int64, device=q1.device)
    for e in range(4):
        polys, counts = _clip(polys, counts, q2[:, e], q2[:, (e + 1) % 4])
    inter = torch.where(counts > 2, _area(polys), torch.zeros_like(polys[:, 0, 0]))
    union = _area(q1) + _area(q2) - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(union))


def quad_iou_matrix_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU: a (N, 4, 2), b (M, 4, 2) → (N, M)."""
    n, m = a.shape[0], b.shape[0]
    return quad_iou_pairs_plain(
        a.repeat_interleave(m, dim=0), b.repeat(n, 1, 1)
    ).reshape(n, m)


def gather_cost(n_quads: int, n_pairs: int, live_pairs: int, n_counts: int = 0):
    """(FLOPs, bytes) of one gathered call: ``live_pairs`` of its ``n_pairs``
    pairs clipped; the quads, both index vectors, the live counts and the
    output each moved once."""
    return live_pairs * OPS_PER_PAIR, 32 * n_quads + 12 * n_pairs + 4 * n_counts


def matrix_cost(n: int, m: int):
    """(FLOPs, bytes) of ``quad_iou_matrix`` on N × M quads."""
    return n * m * OPS_PER_PAIR, 32 * (n + m) + 4 * n * m


def call_flops(n_pairs: int, n_live=None) -> float:
    """FLOPs of a launch over ``n_pairs`` pairs with the live counts
    ``n_live`` (None: all pairs; a 0-d or (B,) tensor, read on the host)."""
    if n_live is None:
        return float(n_pairs * OPS_PER_PAIR)
    cap = _live_slots(n_pairs, n_live)
    live = n_live.reshape(-1).cpu().clamp(0, cap).sum().item()
    return float(live * OPS_PER_PAIR)


def _live_slots(n_pairs: int, n_live) -> int:
    """Pairs per page: all P for a 0-d count, P / B for a (B,) one."""
    if n_live.dim() == 0:
        return n_pairs
    if n_live.dim() != 1 or n_live.shape[0] == 0 or n_pairs % n_live.shape[0]:
        raise ValueError(
            f"quad_iou: {n_pairs} pairs do not split into pages of n_live "
            f"{tuple(n_live.shape)}"
        )
    return n_pairs // n_live.shape[0]


def quad_iou_gather_plain(quads, ia, ib, n_live=None) -> torch.Tensor:
    """IoU of quads[ia[p]] with quads[ib[p]]: quads (M, 4, 2), ia/ib (P,)
    int → (P,); 0 for p ≥ n_live when ``n_live`` is a 0-d int tensor, and
    for p mod cap ≥ n_live[p div cap] when it is (B,) with cap = P / B;
    None clips all P."""
    iou = quad_iou_pairs_plain(quads[ia.long()], quads[ib.long()])
    if n_live is None:
        return iou
    cap = _live_slots(ia.shape[0], n_live)
    p = torch.arange(ia.shape[0], device=ia.device)
    live = (p % cap) < n_live.reshape(-1)[p // cap]
    return torch.where(live, iou, torch.zeros_like(iou))


def _lib():
    lib = _build.library("quad_iou")
    if lib.quad_iou_pairs_launch.argtypes is None:
        ptr, i64 = ctypes.c_void_p, ctypes.c_longlong
        lib.quad_iou_pairs_launch.argtypes = [ptr, ptr, ptr, i64, ptr]
        lib.quad_iou_matrix_launch.argtypes = [ptr, ptr, ptr, i64, i64, ptr]
        lib.quad_iou_gather_launch.argtypes = [ptr, ptr, ptr, ptr, ptr, i64, i64, ptr]
        # K3, the scan LANMS's merge chain (wrapped in ops/lanms_torch.py)
        lib.lanms_merge_scan_launch.argtypes = [
            ptr, i64, i64, ctypes.c_float, i64, ptr, ptr, ptr, ptr
        ]
        for fn in ("quad_iou_pairs_launch", "quad_iou_matrix_launch",
                   "quad_iou_gather_launch", "lanms_merge_scan_launch"):
            getattr(lib, fn).restype = ctypes.c_int
    return lib


def _require(t: torch.Tensor, name: str):
    if t.device.type != "cuda":
        raise ValueError(f"quad_iou: {name} is on {t.device}, not CUDA")
    if t.dtype != torch.float32:
        raise TypeError(f"quad_iou: {name} is {t.dtype}, needs float32")
    if t.dim() != 3 or tuple(t.shape[1:]) != (4, 2):
        raise ValueError(f"quad_iou: {name} has shape {tuple(t.shape)}, needs (n, 4, 2)")
    if not t.is_contiguous():
        raise ValueError(f"quad_iou: {name} is not contiguous")


def quad_iou_pairs_cuda(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    global launches
    _require(q1, "q1")
    _require(q2, "q2")
    if q1.shape[0] != q2.shape[0]:
        raise ValueError(f"quad_iou: {q1.shape[0]} vs {q2.shape[0]} pairs")
    out = torch.empty(q1.shape[0], dtype=torch.float32, device=q1.device)
    status = _lib().quad_iou_pairs_launch(
        q1.data_ptr(), q2.data_ptr(), out.data_ptr(), q1.shape[0],
        torch.cuda.current_stream(q1.device).cuda_stream,
    )
    _build.check(status, "quad_iou_pairs")
    launches += 1
    if flop_calls is not None:
        flop_calls.append((q1.shape[0], None))
    return out


def quad_iou_matrix_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    global launches
    _require(a, "a")
    _require(b, "b")
    out = torch.empty(a.shape[0], b.shape[0], dtype=torch.float32, device=a.device)
    status = _lib().quad_iou_matrix_launch(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), a.shape[0], b.shape[0],
        torch.cuda.current_stream(a.device).cuda_stream,
    )
    _build.check(status, "quad_iou_matrix")
    launches += 1
    if flop_calls is not None:
        flop_calls.append((a.shape[0] * b.shape[0], None))
    return out


def quad_iou_gather_cuda(quads, ia, ib, n_live=None) -> torch.Tensor:
    """One launch: the pairs are gathered by the kernel and only the live
    ones (below ``n_live``, or below each page's ``n_live[b]`` in its block
    of P / B slots; read on the device, no host sync) are clipped. Indices
    must lie in [0, M); the kernel does not check them."""
    global launches
    _require(quads, "quads")
    for name, idx in (("ia", ia), ("ib", ib)):
        if idx.device != quads.device:
            raise ValueError(f"quad_iou: {name} is on {idx.device}, not {quads.device}")
        if idx.dtype != torch.int32:
            raise TypeError(f"quad_iou: {name} is {idx.dtype}, needs int32")
        if idx.dim() != 1 or not idx.is_contiguous():
            raise ValueError(f"quad_iou: {name} must be a contiguous vector")
    if ia.shape != ib.shape:
        raise ValueError(f"quad_iou: {ia.shape[0]} vs {ib.shape[0]} indices")
    if n_live is not None:
        if n_live.device != quads.device:
            raise ValueError(f"quad_iou: n_live is on {n_live.device}, not {quads.device}")
        if n_live.dtype != torch.int32 or n_live.dim() > 1:
            raise TypeError(
                f"quad_iou: n_live must be a 0-d or (B,) int32 tensor, got "
                f"{n_live.dtype} {tuple(n_live.shape)}"
            )
        n_live = n_live.contiguous()
    cap = ia.shape[0] if n_live is None else _live_slots(ia.shape[0], n_live)
    out = torch.empty(ia.shape[0], dtype=torch.float32, device=quads.device)
    status = _lib().quad_iou_gather_launch(
        quads.data_ptr(), ia.data_ptr(), ib.data_ptr(),
        None if n_live is None else n_live.data_ptr(), out.data_ptr(), ia.shape[0],
        cap, torch.cuda.current_stream(quads.device).cuda_stream,
    )
    _build.check(status, "quad_iou_gather")
    launches += 1
    if flop_calls is not None:
        flop_calls.append((ia.shape[0], None if n_live is None else n_live.clone()))
    return out


def quad_iou_gather(quads, ia, ib, n_live=None) -> torch.Tensor:
    """Plain torch ops for CPU tensors, the CUDA kernel otherwise."""
    if quads.device.type == "cpu":
        return quad_iou_gather_plain(quads, ia, ib, n_live)
    return quad_iou_gather_cuda(quads, ia, ib, n_live)


def quad_iou_pairs(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Plain torch ops for CPU tensors, the CUDA kernel otherwise."""
    if q1.device.type == "cpu":
        return quad_iou_pairs_plain(q1, q2)
    return quad_iou_pairs_cuda(q1, q2)


def quad_iou_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain torch ops for CPU tensors, the CUDA kernel otherwise."""
    if a.device.type == "cpu":
        return quad_iou_matrix_plain(a, b)
    return quad_iou_matrix_cuda(a, b)
