"""The port's attention decoder (greedy and beam search) against the JAX
package's ``AttentionDecoder``, on the CPU: equal tokens, logits within
1e-4 (float32 sums taken in another order). The decode step runs the plain
twin of the CUDA kernel here."""

import numpy as np
import pytest
import torch

from manuscript_tpu.models.attention import AttentionDecoder as JaxDecoder
from manuscript_tpu_torch.models.attention import AttentionDecoder, topk_lowest_index
from manuscript_tpu_torch.utils.weights import params_from_jax

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False


def _params(rng, h, v):
    f = lambda *s, sc: (rng.standard_normal(s) * sc).astype(np.float32)
    return {
        "i2h_kernel": f(h, h, sc=h**-0.5), "h2h_kernel": f(h, h, sc=h**-0.5),
        "h2h_bias": f(h, sc=0.1), "score_kernel": f(h, 1, sc=h**-0.5),
        "lstm_kernel_ih": f(h + v, 4 * h, sc=h**-0.5),
        "lstm_kernel_hh": f(h, 4 * h, sc=h**-0.5), "lstm_bias": f(4 * h, sc=0.1),
        "gen_kernel": f(h, v, sc=2 * h**-0.5), "gen_bias": f(v, sc=0.5),
    }


def _pair(seed, b=3, t=8, h=64, v=50, blank_id=None):
    rng = np.random.default_rng(seed)
    params = _params(rng, h, v)
    jdec = JaxDecoder(enc_dim=h, hidden_size=h, num_classes=v, blank_id=blank_id)
    tdec = AttentionDecoder(h, h, v, blank_id=blank_id)
    tdec.load_state_dict(params_from_jax({"params": params}))
    enc = rng.standard_normal((b, t, h)).astype(np.float32)
    return jdec, {"params": params}, tdec, enc


@pytest.mark.parametrize("seed,blank_id", [(0, None), (1, 3)])
def test_greedy_matches_jax(seed, blank_id):
    jdec, jvars, tdec, enc = _pair(seed, blank_id=blank_id)
    jl, jp = jdec.apply(jvars, enc, max_len=10, method="greedy")
    with torch.no_grad():
        tl, tp = tdec.greedy(torch.from_numpy(enc), max_len=10)
    assert tp.shape == (3, 11)  # greedy runs max_len + 1 steps
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)


@pytest.mark.parametrize("seed,blank_id,alpha", [(0, None, 0.9), (2, 3, 0.9), (3, None, 0.0)])
def test_beam_matches_jax(seed, blank_id, alpha):
    jdec, jvars, tdec, enc = _pair(seed, blank_id=blank_id)
    kw = dict(max_len=10, beam_size=4, alpha=alpha, temperature=1.7)
    jl, jt = jdec.apply(jvars, enc, method="beam", **kw)
    with torch.no_grad():
        tl, tt = tdec.beam(torch.from_numpy(enc), **kw)
    assert tt.shape == (3, 10)  # beam runs max_len steps
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)


def test_beam_with_tied_dead_beams_matches_jax():
    """V = 3 < beam 4: the first step has fewer live candidates than beams,
    so picks come from the dead beams at −1e30, exact ties that must break
    to the lowest flat index as jax.lax.top_k does."""
    jdec, jvars, tdec, enc = _pair(5, b=2, t=4, h=16, v=3)
    kw = dict(max_len=6, beam_size=4, alpha=0.9, temperature=1.7)
    jl, jt = jdec.apply(jvars, enc, method="beam", **kw)
    with torch.no_grad():
        tl, tt = tdec.beam(torch.from_numpy(enc), **kw)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)


def test_topk_breaks_ties_to_lowest_index():
    x = torch.tensor([[1.0, 5.0, 5.0, -1e30, -1e30, 5.0, -1e30]])
    vals, idx = topk_lowest_index(x, 5)
    assert idx.tolist() == [[1, 2, 5, 0, 3]]
    assert torch.equal(vals, x[:, [1, 2, 5, 0, 3]])
