"""A/B benchmark of the port's hand-written kernels against their plain
torch twins, one JSON line per configuration.

The port's counterpart of ``examples/pallas_bench.py`` (the Pallas kernels
against their XLA forms):

* K1 ``attention_step`` (``csrc/attention_step.cu``), one beam-8 decode step
  at R = 256, 1024 and 4096 beam rows, T 32, H 256, E 256, 194 tokens;
* K2 ``quad_iou_gather`` (``csrc/quad_iou.cu``) over the predecessor pairs
  of 1024 and 8192 candidates, and ``quad_iou_matrix`` at 256² and 1024²;
* K3 ``lanms_merge_scan`` (``csrc/quad_iou.cu``) at 2048 and 8192 live
  candidates and on a page of 8192 that is one unbroken chain (jittered
  copies of one word), max_out 1024; on the card also its settings on each
  of these pages, one ``{"sweep": "lanms_merge_scan", ...}`` line each:
  chunk lengths of 32 to 512 chunks a page (one thread a chunk) against
  re-walk limits 1 to 64, each held bit-equal to one thread's walk, with
  the kernel's record (fix-up rounds, re-walks, rows) and ``default`` true
  for the wrapper's own setting;
* a greedy TRBA decode of 64 crops at full width (hidden 256, 194 tokens,
  25 steps), its decoder stepping through K1 and through the plain twin;
* the EAST step's multi-tensor kernels (``csrc/multi_tensor.cu``) at the
  leaf set of ``EASTModel("resnet101")`` (348 leaves, 47,185,801
  elements, the KxK convolutions' gradients channels_last as autograd
  returns them): ASAM's perturbation (sum of squares and perturb), its
  restore, each against its twin given the kernel's own norm, and the
  guarded clip → SGD → apply (the optimizer's fused ``step``) over the same
  leaves against the transforms it fuses (whose norm sums in another
  order).

On the card a kernel's ms is ``utils.profiling.graph_time_ms`` (CUDA events
over a CUDA graph of repeated calls); the plain K3 loop and the decode,
which wait on the host, are timed with CUDA events around whole calls.
``bound_ms`` is ``utils.profiling.bound_ms`` of the call's bytes and
operations (``attention_step.step_cost``, ``quad_iou.gather_cost``/
``matrix_cost``, one clip per live K3 step, ``multi_tensor.cost``), as
``chip_smoke.py`` counts them. On the CPU (``--cpu``) the wrappers run their plain twins, so
``route`` says "plain" and both columns time the twin.
``MANUSCRIPT_TPU_BENCH_SMOKE=1`` runs tiny shapes. Every line names the
card:

    python examples/torch_port/kernel_bench.py
"""

import argparse
import json
import os
import sys
from contextlib import contextmanager
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

# random weights by design: no checkpoint is fetched
os.environ.setdefault("MANUSCRIPT_TPU_NO_DOWNLOAD", "1")
os.environ.setdefault("MANUSCRIPT_TPU_ALLOW_RANDOM_INIT", "1")


def synth_quads(m: int, seed: int = 0) -> np.ndarray:
    """Word-like convex quads over a 1280² page, (M, 4, 2) f32."""
    rng = np.random.default_rng(seed)
    out = np.empty((m, 4, 2), np.float32)
    for i in range(m):
        x0, y0 = rng.uniform(0, 1200), rng.uniform(0, 1240)
        w, h = rng.uniform(30, 120), rng.uniform(12, 40)
        quad = np.array([[x0, y0], [x0 + w, y0], [x0 + w, y0 + h], [x0, y0 + h]], np.float32)
        out[i] = quad + rng.normal(0, 1.0, (4, 2)).astype(np.float32)
    return out


def sorted_candidates(n: int, seed: int = 0) -> np.ndarray:
    """(n, 9) live candidates, 16 jittered copies a word, sorted by x0 (the
    merge walk's input order)."""
    rng = np.random.default_rng(seed)
    words = synth_quads(max(1, n // 16), seed).reshape(-1, 8)
    rows = words[rng.integers(0, len(words), n)] + rng.normal(0, 2.0, (n, 8)).astype(np.float32)
    rows = np.concatenate([rows, rng.uniform(0.5, 1, (n, 1)).astype(np.float32)], 1)
    return rows[np.argsort(rows[:, 0], kind="stable")]


def one_chain_candidates(n: int, seed: int = 0) -> np.ndarray:
    """(n, 9) jittered copies of one word box, sorted by x0: a page whose
    merge walk never breaks."""
    rng = np.random.default_rng(seed)
    word = synth_quads(1, seed).reshape(8)
    rows = word + rng.normal(0, 2.0, (n, 8)).astype(np.float32)
    rows = np.concatenate([rows, rng.uniform(0.5, 1, (n, 1)).astype(np.float32)], 1)
    return rows[np.argsort(rows[:, 0], kind="stable")]


def k3_sweep(k3, rows, field: str, device: str) -> None:
    """K3's settings on one page of ``rows`` (1, n, 9) on the card: chunk
    lengths that give 32 to 512 chunks (one thread each) against re-walk
    limits, each bit-equal to one thread's walk (``_chunk=n``); one JSON
    line each with its ms and the kernel's record."""
    import torch

    from manuscript_tpu_torch.utils.profiling import graph_time_ms

    n = rows.shape[1]
    walk = k3.lanms_merge_scan_cuda(rows, 0.2, 1024, _chunk=n)
    threads = k3._k3_threads(n)
    default = max(k3._K3_MIN_CHUNK, -(-n // threads))  # the wrapper's chunks on a live page
    for chunk in (4, 8, 16, 32, 64, 128, 256):
        if not 32 <= n // chunk <= k3._K3_THREADS:
            continue
        for rewalks in (1, 2, 4, 8, 64):
            record = {}
            got = k3.lanms_merge_scan_cuda(rows, 0.2, 1024, _chunk=chunk, _rewalks=rewalks,
                                           _stats=record)
            if not all(torch.equal(g, w) for g, w in zip(got, walk)):
                raise RuntimeError(f"lanms_merge_scan: chunk {chunk}, rewalks {rewalks} "
                                   "differs from one thread's walk")
            rounds, rewalked, walked, most, _ = record["fixup"][0].tolist()
            ms = graph_time_ms(lambda: k3.lanms_merge_scan_cuda(
                rows, 0.2, 1024, _chunk=chunk, _rewalks=rewalks), calls=3, replays=3)
            print(json.dumps({
                "sweep": "lanms_merge_scan", "field": field, "candidates": n, "chunk": chunk,
                "threads": k3._k3_threads(n, chunk), "rewalks": rewalks, "route": "cuda",
                "ms": round(ms, 5),
                "fixup_rounds": rounds, "rewalked": rewalked, "rows_rewalked": walked,
                "most_rows": most, "default": chunk == default and rewalks == k3._K3_REWALKS,
                "device": device}), flush=True)


@contextmanager
def plain_decoder_steps():
    """The decoder's steps through K1's plain twin (a CUDA tensor otherwise
    launches K1)."""
    from manuscript_tpu_torch.models import attention
    from manuscript_tpu_torch.ops.attention_step import attention_step_plain

    saved = attention.attention_step
    attention.attention_step = attention_step_plain
    try:
        yield
    finally:
        attention.attention_step = saved


def main(argv=None):
    import torch

    from manuscript_tpu_torch.ops import attention_step as k1
    from manuscript_tpu_torch.ops import lanms_torch as k3
    from manuscript_tpu_torch.ops import quad_iou as k2
    from manuscript_tpu_torch.ops.lanms_torch import _predecessor_pairs
    from manuscript_tpu_torch.utils.device import add_cpu_flag, card_name, script_device
    from manuscript_tpu_torch.utils.profiling import bound_ms, call_ms, graph_time_ms

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_cpu_flag(ap)
    args = ap.parse_args(argv)
    dev = script_device(args.cpu)
    device, cuda = card_name(dev), dev.type == "cuda"
    smoke = os.environ.get("MANUSCRIPT_TPU_BENCH_SMOKE") == "1"
    # CUDA graphs on the card, the host clock on the CPU
    kernel_ms = graph_time_ms if cuda else (lambda fn: call_ms(fn, dev, calls=5))
    twin_ms = (lambda fn: graph_time_ms(fn, calls=2, replays=3)) if cuda else kernel_ms
    lines = []

    def emit(name, config, got, want, ms, plain_ms, cost):
        err = max(float((g.float() - w.float()).abs().max()) if g.numel() else 0.0
                  for g, w in zip(got, want))
        b_ms, b_by = bound_ms(cost[1], cost[0])
        line = {"kernel": name, **config, "route": "cuda" if cuda else "plain",
                "ms": round(ms, 5), "plain_ms": round(plain_ms, 5), "bound_ms": round(b_ms, 6),
                "bound_by": b_by, "max_abs_err": err, "device": device}
        print(json.dumps(line), flush=True)
        lines.append(line)

    gen = torch.Generator().manual_seed(0)
    rn = lambda *s, sc=1.0: (torch.randn(*s, generator=gen) * sc).to(dev)  # noqa: E731

    # ---- K1: one beam-8 decode step ----
    # the kernels take H a multiple of 64 and E one of 16
    t, hid, e_dim, v, beam = (8, 64, 64, 20, 8) if smoke else (32, 256, 256, 194, 8)
    w = (rn(hid, hid, sc=hid**-0.5), rn(hid, sc=0.1), rn(hid, sc=hid**-0.5),
         rn(e_dim + v, 4 * hid, sc=e_dim**-0.5), rn(hid, 4 * hid, sc=hid**-0.5),
         rn(4 * hid, sc=0.1))
    for rows in ((16, 64) if smoke else (256, 1024, 4096)):
        words = rows // beam
        a = (rn(words, t, e_dim), rn(words, t, hid), rn(rows, hid, sc=0.5), rn(rows, hid, sc=0.5),
             torch.randint(0, v, (rows,), generator=gen, dtype=torch.int32).to(dev), *w)
        got = k1.attention_step(*a, beam=beam)
        want = k1.attention_step_plain(*a, beam=beam)
        n_tok = int(torch.unique(a[4]).numel())
        emit("attention_step", {"rows": rows, "beam": beam, "T": t, "H": hid, "E": e_dim, "V": v},
             got, want, kernel_ms(lambda: k1.attention_step(*a, beam=beam)),
             twin_ms(lambda: k1.attention_step_plain(*a, beam=beam)),
             k1.step_cost(words, rows, t, hid, e_dim, n_tok))

    # ---- K2: gathered predecessor pairs and the matrix ----
    for n in ((64,) if smoke else (1024, 8192)):
        quads = torch.from_numpy(synth_quads(n)).to(dev)
        ia, ib = _predecessor_pairs(1, n, dev)
        emit("quad_iou_gather", {"pairs": n - 1, "quads": n},
             [k2.quad_iou_gather(quads, ia, ib)], [k2.quad_iou_gather_plain(quads, ia, ib)],
             kernel_ms(lambda: k2.quad_iou_gather(quads, ia, ib)),
             twin_ms(lambda: k2.quad_iou_gather_plain(quads, ia, ib)),
             k2.gather_cost(n, n - 1, n - 1))
    for m in ((32,) if smoke else (256, 1024)):
        a_q = torch.from_numpy(synth_quads(m, seed=1)).to(dev)
        b_q = torch.from_numpy(synth_quads(m, seed=2)).to(dev)
        emit("quad_iou_matrix", {"m": m, "n": m},
             [k2.quad_iou_matrix(a_q, b_q)], [k2.quad_iou_matrix_plain(a_q, b_q)],
             kernel_ms(lambda: k2.quad_iou_matrix(a_q, b_q)),
             twin_ms(lambda: k2.quad_iou_matrix_plain(a_q, b_q)), k2.matrix_cost(m, m))

    # ---- K3: the scan LANMS's merge walk ----
    k3_fields = [("words", n, sorted_candidates) for n in ((128,) if smoke else (2048, 8192))]
    k3_fields.append(("one chain", 128 if smoke else 8192, one_chain_candidates))
    for field, n, make in k3_fields:
        rows = torch.from_numpy(make(n)).to(dev)[None].contiguous()
        got = k3.lanms_merge_scan(rows, 0.2, 1024)
        want = k3.lanms_merge_scan_plain(rows, 0.2, 1024)
        m = min(int(want[2][0]), 1024)
        if not torch.equal(got[2], want[2]):
            raise RuntimeError(f"lanms_merge_scan: counts {got[2]} vs the twin's {want[2]}")
        kernel = lambda: k3.lanms_merge_scan(rows, 0.2, 1024)  # noqa: E731
        plain = lambda: k3.lanms_merge_scan_plain(rows, 0.2, 1024)  # noqa: E731
        emit("lanms_merge_scan",
             {"field": field, "candidates": n, "max_out": 1024, "merged": int(want[2][0])},
             [got[0][0, :m], got[1][0, :m]], [want[0][0, :m], want[1][0, :m]],
             (graph_time_ms(kernel, calls=5, replays=5) if cuda else call_ms(kernel, dev, calls=1)),
             call_ms(plain, dev, calls=1), (n * 860, rows.numel() * 4 + 1024 * 9 * 4 + 4))
        if cuda:
            k3_sweep(k3, rows, field, device)

    # ---- a greedy TRBA decode, its steps through K1 and through the twin ----
    from manuscript_tpu_torch.ops.image import normalize_u8
    from manuscript_tpu_torch.recognizers import TRBA

    tiny = dict(cnn_stage_plan="micro", hidden_size=64, img_h=32, img_w=128, max_length=8)
    trba = TRBA(device=dev, allow_random_init=True, seed=1, **(tiny if smoke else {}))
    n_crops = 8 if smoke else 64
    crops = torch.from_numpy(np.random.default_rng(1).integers(
        0, 255, (n_crops, trba.img_h, trba.img_w, 3), dtype=np.uint8)).to(dev)

    def decode():
        return trba.recognize_tensor(crops, "greedy")

    got = decode()
    ms = call_ms(decode, dev, calls=3)
    with plain_decoder_steps():
        want = decode()
        plain = call_ms(decode, dev, calls=3)
    steps = trba.max_length
    h, e = trba.model.decoder.h2h_kernel.shape[0], trba.model.decoder.i2h_kernel.shape[0]
    v = trba.model.decoder.gen_kernel.shape[1]
    with torch.inference_mode():
        t_enc = int(trba.model.encode(normalize_u8(crops[:1], trba.dtype)).shape[1])
    step = k1.step_cost(n_crops, n_crops, t_enc, h, e, v)
    emit("trba_greedy_decode", {"crops": n_crops, "steps": steps, "hidden": h, "T": t_enc},
         [got[1]], [want[1]], ms, plain, (steps * step[0], steps * step[1]))

    # ---- the EAST step's multi-tensor kernels at the detector's leaf set ----
    from manuscript_tpu_torch.models.east import EASTModel
    from manuscript_tpu_torch.ops import multi_tensor as mt
    from manuscript_tpu_torch.train import optim

    with torch.device("meta"):
        east = EASTModel("resnet50-micro" if smoke else "resnet101")
    shapes = [p.shape for p in east.parameters()]
    params = [rn(*s) for s in shapes]
    grads = [rn(*s, sc=1e-2) for s in shapes]
    grads = [g.contiguous(memory_format=torch.channels_last) if g.dim() == 4 else g for g in grads]
    traces = [rn(*s, sc=1e-3) for s in shapes]
    loss = torch.tensor(1.0, device=dev)
    norm = torch.empty(1, device=dev)
    config = {"leaves": len(shapes), "elements": sum(p.numel() for p in params)}
    clone = lambda ts: [t.clone() for t in ts]  # noqa: E731
    perturb = mt.perturb_cuda if cuda else mt.perturb_plain
    if cuda:
        got = clone(params)
        saved = mt.perturb_cuda(got, grads, 0.05, True, norm_out=norm)
        want = clone(params)
        mt.perturb_plain(want, grads, 0.05, True, norm=norm[0])
    else:
        got, want = clone(params), clone(params)
        saved = mt.perturb_plain(got, grads, 0.05, True)
        mt.perturb_plain(want, grads, 0.05, True)
    work = clone(params)
    emit("multi_tensor_perturb", config, got, want,
         kernel_ms(lambda: perturb(work, grads, 0.05, True)),
         twin_ms(lambda: mt.perturb_plain(work, grads, 0.05, True)),
         mt.cost("perturb", config["elements"]))
    restore = mt.restore_cuda if cuda else mt.restore_plain
    restore(got, saved)
    copies = clone(params)
    emit("multi_tensor_restore", config, got, params, kernel_ms(lambda: restore(work, saved)),
         twin_ms(lambda: mt.restore_plain(work, copies)), mt.cost("restore", config["elements"]))
    tx, _ = optim.build_east_optimizer(1e-3, 1, use_sam=True, grad_clip=5.0)
    keys = [str(i) for i in range(len(shapes))]

    def update(p, t):  # the kernels on a card; on the CPU the transforms
        state = {"0": {}, "1": {"0": {"trace": dict(zip(keys, t))}, "1": {"count": 0}}}
        state = tx.step(loss, dict(zip(keys, grads)), state, dict(zip(keys, p)))
        return list(state["1"]["0"]["trace"].values())

    def transforms(p, t):  # guard → clip → SGD → apply, as the optimizer states them
        state = {"0": {}, "1": {"0": {"trace": dict(zip(keys, t))}, "1": {"count": 0}}}
        updates, state = tx.update(optim.guard_finite(loss, dict(zip(keys, grads))), state,
                                   dict(zip(keys, p)))
        optim.apply_updates(dict(zip(keys, p)), updates)
        return list(state["1"]["0"]["trace"].values())

    p_k, p_t = clone(params), clone(params)
    t_k, t_t = update(p_k, clone(traces)), transforms(p_t, clone(traces))
    p_w, t_w = clone(params), clone(traces)  # the timed calls update these
    emit("multi_tensor_update", config, p_k + t_k, p_t + t_t,
         kernel_ms(lambda: update(p_w, t_w)), twin_ms(lambda: transforms(p_w, t_w)),
         mt.cost("update", config["elements"]))
    return lines


if __name__ == "__main__":
    main()
