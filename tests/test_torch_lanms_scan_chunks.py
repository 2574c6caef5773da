"""A model of K3's chunked merge walk (``lanms_merge_scan_kernel`` in
``manuscript_tpu_torch/csrc/quad_iou.cu``) against the plain twin
``ops/lanms_torch.lanms_merge_scan_plain``, on the CPU.

The kernel cuts a page's live extent into chunks of L rows, walks each
chunk as if it began the page, re-walks in rounds every chunk whose
predecessor's end state changed until it rejoins its record (the first row
where both walks open a quad), then scans the chunks' close counts into
slots. The model does the same passes in Python with the plain twin's own
per-row step (``_merge_step``), so outputs equal with ``torch.equal`` mean
that the passes give the sequential walk's result, not just a close one.
"""

import functools

import numpy as np
import pytest
import torch

from manuscript_tpu_torch.ops import lanms_torch as tl

torch.set_num_threads(1)

THR = 0.2
def chunked_walk(rows: torch.Tensor, thr: float, max_out: int, chunk: int, threads=None,
                 rewalks: int = tl._K3_REWALKS):
    """K3's three passes on one page, (K, 9) x0-sorted rows, chunks of
    ``chunk`` rows (0: the live extent over ``threads``, the wrapper's
    count by default, at least ``_K3_MIN_CHUNK`` rows) → (out_p, out_s,
    count, per-row codes, fix-up rounds, rows of each re-walk)."""
    k = rows.shape[0]
    quads, scores = rows[:, :8].reshape(k, 4, 2), rows[:, 8]
    live = (scores >= 0).tolist()
    n = max((r + 1 for r in range(k) if live[r]), default=0)
    span = chunk or max(tl._K3_MIN_CHUNK, -(-n // (threads or tl._k3_threads(k))))
    n_chunks = -(-n // span)
    bounds = [(c * span, min(c * span + span, n)) for c in range(n_chunks)]
    code, closed, end = [0] * k, [None] * k, [None] * n_chunks

    def walk(c, state, rejoin):
        walked = 0
        for r in range(*bounds[c]):
            if not live[r]:
                code[r] = 0
                continue
            walked += 1
            new, opened = tl._merge_step(state, quads[r], scores[r], thr)
            if not opened:
                code[r], state = 0, new
                continue
            old = code[r]
            code[r], closed[r] = (1 if state is None else 2), state
            if rejoin and old:
                return state, True, walked
            state = new
        return state, False, walked

    # 1. speculative: each chunk from no running quad
    for c in range(n_chunks):
        end[c] = walk(c, None, False)[0]
    changed = [e is not None for e in end]  # the successor walked from no quad
    stale, walks = [False] * n_chunks, [0] * n_chunks
    # 2. fix-up rounds, every chunk of a round from the states of the one
    # before; the front (the first stale chunk) always walks, the others
    # while they have re-walks left
    rounds, rewalked = 0, []
    while True:
        for c in range(1, n_chunks):
            stale[c] |= changed[c - 1]
        front = next((c for c in range(n_chunks) if stale[c]), n_chunks)
        todo = [stale[c] and (c == front or walks[c] < rewalks) for c in range(n_chunks)]
        enter = [end[c - 1] if todo[c] else None for c in range(n_chunks)]
        for c in range(n_chunks):
            changed[c] = False
            if todo[c]:
                state, rejoined, walked = walk(c, enter[c], True)
                rewalked.append(walked)
                stale[c], walks[c] = False, walks[c] + 1
                if not rejoined:
                    end[c], changed[c] = state, c + 1 < n_chunks
        rounds += any(todo)
        if not any(stale) and not any(changed):
            break
    # 3. output: each chunk's first slot from the scan of the close counts
    counts = [sum(code[r] == 2 for r in range(*b)) for b in bounds]
    first = np.concatenate([[0], np.cumsum(counts)]).astype(int)
    out_p = torch.zeros(max_out, 4, 2, dtype=rows.dtype)
    out_s = torch.full((max_out,), -float("inf"), dtype=rows.dtype)
    for c, b in enumerate(bounds):
        j = first[c]
        for r in range(*b):
            if code[r] == 2:
                if j < max_out - 1:
                    out_p[j], out_s[j] = closed[r][0], closed[r][1]
                j += 1
    m = int(first[-1]) + (n_chunks > 0)
    if n_chunks:
        slot = min(m - 1, max_out - 1)
        out_p[slot], out_s[slot] = end[-1][0], end[-1][1]
    return out_p, out_s, m, code, rounds, rewalked


def x0_sorted(cands: np.ndarray) -> torch.Tensor:
    """(B, K, 9) candidates in the walk's order: by x0, stable, padding last."""
    c = torch.from_numpy(cands.astype(np.float32))
    key = torch.where(c[..., 8] >= 0, c[..., 0], torch.full_like(c[..., 0], float("inf")))
    order = torch.sort(key, dim=1, stable=True).indices
    return c[torch.arange(c.shape[0])[:, None], order].contiguous()


def field(rng, n, words, pad=0, size=400.0):
    """Jittered copies of word boxes, scores in [0.5, 1), ``pad`` padding
    rows (score −1), shuffled: (n + pad, 9)."""
    c = rng.uniform(0, size, (words, 2))
    wh = np.stack([rng.uniform(40, 160, words), rng.uniform(15, 40, words)], 1)
    base = np.concatenate([c - wh / 2, c + [1, -1] * wh / 2, c + wh / 2, c + [-1, 1] * wh / 2], 1)
    rows = base[rng.integers(0, words, n)] + rng.normal(0, 2.0, (n, 8))
    rows = np.concatenate([rows, rng.uniform(0.5, 1, (n, 1))], 1)
    rows = np.concatenate([rows, np.full((pad, 9), -1.0)])
    return rows[rng.permutation(len(rows))]


def one_chain(rng, n):
    """``n`` jittered copies of one word box: every row merges into one quad."""
    base = np.array([100, 50, 200, 50, 200, 80, 100, 80], float)
    rows = base + rng.normal(0, 2.0, (n, 8))
    return np.concatenate([rows, rng.uniform(0.5, 1, (n, 1))], 1)


def _ties(rng):
    cands = field(rng, 60, words=8)
    cands[::3, 0] = np.round(cands[::3, 0] / 40) * 40  # many exact x0 ties
    cands[::3, 6] = cands[::3, 0]
    return cands[None]


def _two_pages(rng):
    a, b = field(rng, 45, words=8, pad=10), field(rng, 25, words=6, pad=30)
    return np.stack([a, b])


CASES = {  # name → (candidates (B, K, 9) from a seeded rng, max_out)
    "padding_rows": (lambda rng: field(rng, 50, words=8, pad=30)[None], 64),
    "x0_ties": (_ties, 32),
    "one_chain": (lambda rng: one_chain(rng, 30)[None], 8),
    "overflow_1": (lambda rng: field(rng, 45, words=14)[None], 1),
    "overflow_4": (lambda rng: field(rng, 45, words=14)[None], 4),
    "padding_only": (lambda rng: np.full((1, 12, 9), -1.0), 4),
    "one_live_row": (lambda rng: np.concatenate([one_chain(rng, 1), np.full((9, 9), -1.0)])[None], 4),
    "two_pages": (_two_pages, 32),
}


@functools.lru_cache(maxsize=None)
def case(name):
    """(rows, max_out, the plain twin's outputs, each page's record from
    one chunk: the sequential walk's)"""
    make, max_out = CASES[name]
    rows = x0_sorted(make(np.random.default_rng(sorted(CASES).index(name))))
    records = [chunked_walk(page, THR, max_out, rows.shape[1])[3] for page in rows]
    return rows, max_out, tl.lanms_merge_scan_plain(rows, THR, max_out), records


@pytest.mark.parametrize("chunk", [1, 3, 16, "K"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_chunked_walk_model_equals_the_plain_walk(name, chunk):
    """Outputs bit-equal to the sequential walk's at every chunk length, and
    the fixed-up per-row record equal to the sequential walk's record."""
    rows, max_out, (pp, sp, mp), records = case(name)
    for page in range(rows.shape[0]):
        out_p, out_s, m, code, rounds, _ = chunked_walk(
            rows[page], THR, max_out, rows.shape[1] if chunk == "K" else chunk)
        assert m == int(mp[page])
        assert torch.equal(out_p, pp[page]) and torch.equal(out_s, sp[page])
        assert code == records[page]
        if chunk == "K":
            assert rounds == 0  # one chunk: today's sequential walk


@pytest.mark.parametrize("rewalks", [0, 1, 2, 100])
def test_one_chain_costs_one_round_per_chunk(rewalks):
    """The worst case: a page that never breaks never rejoins, so chunk c
    settles in round c (the sequential walk, spread over rounds), and past
    its re-walks a chunk waits for the front instead of walking again."""
    rows, max_out, (pp, sp, mp), _ = case("one_chain")
    out_p, out_s, m, _, rounds, rewalked = chunked_walk(rows[0], THR, max_out, 3,
                                                        rewalks=rewalks)
    assert m == int(mp[0]) == 1 and torch.equal(out_p, pp[0]) and torch.equal(out_s, sp[0])
    assert rounds == 10 - 1  # 30 rows in 10 chunks
    # each chunk c >= 1: min(rewalks, c - 1) walks from a changing predecessor, then its own
    assert len(rewalked) == sum(min(rewalks, c - 1) + 1 for c in range(1, 10))


@pytest.mark.parametrize("threads,span", [(4, 13), (8, 8)])
def test_default_chunks_split_the_live_extent_over_the_threads(threads, span):
    """With no chunk length the live extent (up to the last live row) is cut
    into at most one chunk a thread, of at least ``_K3_MIN_CHUNK`` rows
    (50 live rows: 13 over 4 threads, 8 over 8); the padding past it is
    never walked."""
    rows, max_out, (pp, sp, mp), _ = case("padding_rows")
    out_p, out_s, m, code, rounds, rewalked = chunked_walk(rows[0], THR, max_out, 0,
                                                           threads=threads)
    assert m == int(mp[0]) and torch.equal(out_p, pp[0]) and torch.equal(out_s, sp[0])
    assert rounds >= 1 and max(rewalked) <= span


def test_the_wrapper_launches_one_thread_a_chunk():
    """K3's block: one thread a default chunk of ``_K3_MIN_CHUNK`` rows or a
    given chunk, in whole warps, 512 at most."""
    assert [tl._k3_threads(k) for k in (0, 300, 2048, 4096, 8192, 100_000)] == [
        32, 64, 256, 512, 512, 512]
    assert [tl._k3_threads(8192, c) for c in (1, 16, 32, 64, 8192)] == [512, 512, 256, 128, 32]
