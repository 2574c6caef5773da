"""The train mode of the port's models against the JAX package's, on the CPU
with numpy inputs and weights from a seed:

* ``BatchNorm`` in train mode: outputs and running statistics within 1e-5 of
  flax's (biased variance, momentum 0.9), and ``frozen_batch_stats`` leaves
  the statistics alone;
* the EAST micro model's train-mode maps and moved statistics within 1e-4;
* the decoder's teacher-forced logits at ``ss_prob`` 0 and 1 (dropout off)
  within 1e-4, in plain torch ops that never reach ``attention_step``;
* dropout, DropBlock and the scheduled-sampling coin by their statistics
  (their draws cannot equal JAX's): the keep rate within 3 %, the 1/(1 − p)
  scale exactly, one draw per sample and channel, one coin per sample;
* a fresh model's initialisation: each leaf's std within 10 % of a JAX
  init's, zero biases, unit BatchNorm scales.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manuscript_tpu.models import resnet as jresnet
from manuscript_tpu.models.attention import AttentionDecoder as JaxDecoder
from manuscript_tpu.models.east import EASTModel as JaxEAST
from manuscript_tpu.models.trba import TRBAModel as JaxTRBA
from manuscript_tpu_torch.models import resnet
from manuscript_tpu_torch.models.attention import AttentionDecoder
from manuscript_tpu_torch.models.east import EASTModel
from manuscript_tpu_torch.models.layers import BatchNorm, dropout, frozen_batch_stats
from manuscript_tpu_torch.models.seresnet31 import SEBasicBlock
from manuscript_tpu_torch.models.trba import TRBAModel
from manuscript_tpu_torch.ops import attention_step as k1
from manuscript_tpu_torch.utils.weights import init_random_, params_from_jax

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.parametrize("shape", [(4, 6, 5, 3), (3, 7)])
def test_batchnorm_train_mode_matches_flax(shape):
    rng = np.random.default_rng(0)
    x = (rng.normal(2.0, 3.0, shape)).astype(np.float32)
    c = shape[-1]
    scale, bias = rng.uniform(0.5, 1.5, c).astype(np.float32), rng.normal(0, 1, c).astype(np.float32)
    mean0, var0 = rng.normal(0, 1, c).astype(np.float32), rng.uniform(0.5, 2, c).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean0, "var": var0}}
    ref, mutated = bn.apply(variables, x, mutable=["batch_stats"])

    m = BatchNorm(c)
    m.load_state_dict(params_from_jax(variables))
    m.train()
    xt = torch.from_numpy(np.moveaxis(x, -1, 1).copy())  # channels at dim 1
    got = m(xt)
    np.testing.assert_allclose(np.moveaxis(got.detach().numpy(), 1, -1), np.asarray(ref),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(m.running_mean.numpy(), mutated["batch_stats"]["mean"], atol=1e-5)
    np.testing.assert_allclose(m.running_var.numpy(), mutated["batch_stats"]["var"], atol=1e-5)
    before = m.running_var.clone()
    with frozen_batch_stats(m):
        m(xt * 2)
    assert torch.equal(m.running_var, before) and m.update_stats
    m.eval()  # eval normalizes with the running statistics
    np.testing.assert_allclose(
        np.moveaxis(m(xt).detach().numpy(), 1, -1),
        np.asarray(fnn.BatchNorm(use_running_average=True, epsilon=1e-5).apply(
            {**variables, "batch_stats": mutated["batch_stats"]}, x)), atol=1e-5)


def test_east_train_mode_maps_and_statistics_match_jax():
    rng = np.random.default_rng(1)
    jm = JaxEAST(backbone="resnet50-micro")
    variables = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))
    # non-trivial running statistics
    variables["batch_stats"] = jax.tree_util.tree_map(
        lambda a: (a + rng.uniform(0.1, 0.5, a.shape)).astype(np.float32), variables["batch_stats"])
    x = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    ref, mutated = jax.jit(lambda v, x: jm.apply(v, x, train=True, mutable=["batch_stats"]))(variables, x)
    m = EASTModel("resnet50-micro")
    m.load_state_dict(params_from_jax(variables))
    m.train()
    got = m(torch.from_numpy(x))
    for key in ("score", "geometry"):
        np.testing.assert_allclose(got[key].detach().numpy(), np.asarray(ref[key]), rtol=0, atol=1e-4)
    stats = params_from_jax({"batch_stats": jax.tree_util.tree_map(np.asarray, mutated["batch_stats"])})
    state = m.state_dict()
    for name, want in stats.items():
        np.testing.assert_allclose(state[name].numpy(), want.numpy(), rtol=1e-4, atol=1e-5, err_msg=name)


def test_resnet101_has_the_jax_stage_plan():
    assert resnet.STAGE_BLOCKS["resnet101"] == jresnet.STAGE_BLOCKS["resnet101"] == (3, 4, 23, 3)
    names = [n for _, n in resnet.ResNetFeatures("resnet101").names]
    assert len(names) == 33 and names[-4] == "layer3_22"


class _NoAlphaDropout(JaxDecoder):
    def _cell(self, h, c, enc, proj_enc, onehot, alpha_dropout_rng=None):
        return super()._cell(h, c, enc, proj_enc, onehot, None)


def _decoder_pair(seed, blank_id=3, b=4, t=6, h=16, v=20, steps=7):
    rng = np.random.default_rng(seed)
    jdec = _NoAlphaDropout(enc_dim=h, hidden_size=h, num_classes=v, blank_id=blank_id)
    enc = rng.normal(0, 1, (b, t, h)).astype(np.float32)
    text_in = rng.integers(4, v, (b, steps)).astype(np.int32)
    text_in[:, 0] = 1
    variables = jax.tree_util.tree_map(np.asarray, jdec.init(jax.random.PRNGKey(seed), enc, text_in))
    variables["params"]["gen_bias"] = rng.normal(0, 1, v).astype(np.float32)
    tdec = AttentionDecoder(h, h, v, blank_id=blank_id, dropout_p=0.0)
    tdec.load_state_dict(params_from_jax(variables))
    return jdec, variables, tdec, enc, text_in


@pytest.mark.parametrize("ss_prob", [0.0, 1.0])
def test_teacher_forced_logits_match_jax(ss_prob, monkeypatch):
    jdec, variables, tdec, enc, text_in = _decoder_pair(2)
    ref = jdec.apply(variables, enc, text_in, train=True, ss_prob=ss_prob,
                     rngs={"dropout": jax.random.PRNGKey(5)})

    def refuse(*args, **kwargs):
        raise AssertionError("the teacher-forced forward must not reach attention_step")

    monkeypatch.setattr(k1, "attention_step", refuse)
    monkeypatch.setattr("manuscript_tpu_torch.models.attention.attention_step", refuse)
    tdec.train()
    got = tdec(torch.from_numpy(enc), torch.from_numpy(text_in), ss_prob=ss_prob,
               generator=torch.Generator().manual_seed(0))
    assert got.shape == (4, 7, 20) and got.requires_grad
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=0, atol=1e-4)
    assert np.all(got.detach().numpy()[..., 3] == -1e4)  # BLANK masked


def test_teacher_forced_gradient_matches_jax():
    jdec, variables, tdec, enc, text_in = _decoder_pair(3, blank_id=None)
    target = np.roll(text_in, -1, axis=1)

    def jloss(params, enc):
        lg = jdec.apply({"params": params}, enc, text_in, train=False)
        return jnp.mean(jax.nn.logsumexp(lg, -1) - jnp.take_along_axis(lg, target[..., None], -1)[..., 0])

    jl, (jg, jge) = jax.value_and_grad(jloss, argnums=(0, 1))(variables["params"], enc)
    enc_t = torch.from_numpy(enc).requires_grad_()
    lg = tdec(enc_t, torch.from_numpy(text_in))
    loss = torch.nn.functional.cross_entropy(lg.reshape(-1, 20), torch.from_numpy(target).reshape(-1).long())
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    np.testing.assert_allclose(enc_t.grad.numpy(), np.asarray(jge), rtol=0, atol=1e-5)
    for name, p in tdec.named_parameters():
        want = np.asarray(jg[name])
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=0, atol=1e-4 * max(np.abs(want).max(), 1e-3),
                                   err_msg=name)


def test_scheduled_sampling_coin_is_per_sample_and_never_at_step_0():
    _, _, tdec, enc, text_in = _decoder_pair(4, b=64)
    enc = np.repeat(enc[:1], 64, axis=0)
    text_in = np.repeat(text_in[:1], 64, axis=0)
    tdec.train()
    e, ti = torch.from_numpy(enc), torch.from_numpy(text_in)
    with torch.no_grad():
        forced = tdec(e, ti)
        sampled = tdec(e, ti, ss_prob=0.5, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(sampled[:, 0], forced[:, 0], rtol=0, atol=0)  # step 0: SOS
    fed_back = (sampled[:, 1] - forced[:, 1]).abs().amax(-1) > 1e-6
    # every row has the same input: a per-batch coin would move all rows or none
    assert 16 <= int(fed_back.sum()) <= 48, int(fed_back.sum())
    tdec.eval()  # ss_prob acts in train mode only
    with torch.no_grad():
        torch.testing.assert_close(tdec(e, ti, ss_prob=1.0), forced, rtol=0, atol=0)


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_dropout_keep_rate_and_scale(p):
    x = torch.ones(200_000)
    y = dropout(x, p, torch.Generator().manual_seed(0))
    kept = y != 0
    assert abs(kept.float().mean().item() - (1 - p)) < 0.03 * (1 - p)
    assert torch.all(y[kept] == 1 / (1 - p))
    assert dropout(x, 0.0) is x


def test_dropblock_drops_whole_channels_in_train_mode_only():
    block = SEBasicBlock(32, 32, 1, False, dropblock_p=0.5)
    init_random_(block, 0)
    x = torch.randn(16, 32, 6, 5, generator=torch.Generator().manual_seed(0))
    block.eval()
    with torch.no_grad():
        ref = block(x)
        assert torch.equal(block(x, torch.Generator().manual_seed(1)), ref)
        block.train()
        out = block.conv2(torch.relu(block.bn1(block.conv1(x))))
        masked = dropout(block.se(block.bn2(out)), 0.5, torch.Generator().manual_seed(2), (16, 32, 1, 1))
    per_channel = (masked == 0).flatten(2)
    dropped = per_channel.all(-1)
    assert torch.equal(dropped, per_channel.any(-1))  # a channel is dropped whole or kept
    assert 0.35 < dropped.float().mean().item() < 0.65


@pytest.mark.parametrize("which", ["trba", "east"])
def test_fresh_init_matches_the_jax_init_statistics(which):
    if which == "trba":
        jm = JaxTRBA(num_classes=194, hidden_size=32, cnn_stage_plan="micro")
        variables = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 64, 3)), jnp.zeros((1, 6), jnp.int32))
        model = TRBAModel(194, 32, cnn_stage_plan="micro")
    else:
        jm = JaxEAST(backbone="resnet50-micro")
        variables = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
        model = EASTModel("resnet50-micro")
    init_random_(model, 0)
    ref = params_from_jax(jax.tree_util.tree_map(np.asarray, dict(variables)))
    state = model.state_dict()
    assert set(state) == set(ref)
    checked = 0
    for name, want in ref.items():
        got = state[name]
        if want.numel() >= 512 and want.std() > 0:
            assert abs(got.std().item() / want.std().item() - 1) < 0.1, name
            checked += 1
        else:
            assert (want == want.flatten()[0]).all() == (got == got.flatten()[0]).all(), name
        if name.endswith(("bias", "running_mean")) or (want == 0).all():
            assert (got == 0).all(), name
        if (want == 1).all():
            assert (got == 1).all(), name
    assert checked >= 10
