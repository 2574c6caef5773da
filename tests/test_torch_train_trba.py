"""``manuscript_tpu_torch.train.trba_train`` against the JAX trainer, on the
CPU.

One training step from the committed micro checkpoint (read into both
packages), dropout off in both, SGD at lr 1 under a plateau scale of S = 1e6
(the update is −S·g, large enough that the parameters' own rounding does not
hide g). The JAX trainer's step runs in float32 and in float64
(``jax.enable_x64``); the float64 step's update is −S times the exact
gradient. The port's float32 step: the loss within 1e-5 relative and the
running statistics within 1e-4 of both, and each leaf of its update within
1e-4 of the leaf's largest entry of the exact update, on pixels drawn
uniformly; within 2e-4 on rendered word crops, whose near-white pixels make
the stem's gradient a difference of nearly equal sums in float32 (there the
JAX package's own float32 step is 2 % of a leaf's largest entry from the
exact gradient in the stem's BatchNorms). On both the JAX float32 step is
the farther one from the exact step (``-s`` prints both). The bound fails a
wrong step: one encoder entry in 100 dropped. Then the trainer's own parts (freeze policies
equal to the JAX masks, expN naming and resume-merge, the CSV migration, the
non-finite guard, ``n_devices`` beyond the cards) and small end-to-end runs: 2 epochs and a
resume on a dozen 32×64 crops, a frozen CNN, bfloat16, and a checkpoint that
the JAX package's ``TRBA`` loads and reads as the port does.
"""

import csv
import json
from pathlib import Path

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import manuscript_tpu.models.trba as jtrba_models
from manuscript_tpu.models.attention import AttentionDecoder as JaxDecoder
from manuscript_tpu.models.trba import TRBAModel as JaxTRBAModel
from manuscript_tpu.recognizers.trba import TRBA as JaxTRBA
from manuscript_tpu.train import trba_train as JT
from manuscript_tpu.train.optim import build_trba_optimizer as j_build
from manuscript_tpu.utils.quality import QUALITY_DIR
from manuscript_tpu_torch.models.trba import TRBAModel
from manuscript_tpu_torch.recognizers import TRBA
from manuscript_tpu_torch.recognizers.charset import pack_targets
from manuscript_tpu_torch.train import optim as P
from manuscript_tpu_torch.train import trba_train as PT
from manuscript_tpu_torch.utils.synthetic import VOCAB, build_word_dataset, render_word
from manuscript_tpu_torch.ops.image import resize_and_pad
from manuscript_tpu_torch.utils.weights import params_from_jax

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

CKPT = QUALITY_DIR / "trba_micro.msgpack"
SCALE = 1e6


class _NoAlphaDropout(JaxDecoder):
    def _cell(self, h, c, enc, proj_enc, onehot, alpha_dropout_rng=None):
        return super()._cell(h, c, enc, proj_enc, onehot, None)


@pytest.fixture(scope="module")
def micro():
    raw = flax.serialization.msgpack_restore(CKPT.read_bytes())
    itos = [raw["itos"][str(i)] for i in range(len(raw["itos"]))]
    stoi = {s: i for i, s in enumerate(itos)}
    rng = np.random.default_rng(0)
    words = [str(VOCAB[int(i)]) for i in rng.integers(len(VOCAB), size=4)]
    images = np.stack([resize_and_pad(render_word(w, rng), 32, 128) for w in words])
    text_in, target_y, _ = pack_targets(words, stoi, 12)
    variables = {"params": raw["params"], "batch_stats": raw["batch_stats"]}
    return variables, stoi, images, text_in, target_y


@pytest.fixture(scope="module")
def noise(micro):
    """Pixels drawn uniformly: the batch on which float32 is well conditioned."""
    return np.random.default_rng(1).integers(0, 256, micro[2].shape, dtype=np.uint8)


def _jax_steps(variables, stoi, batches, dtype):
    """The JAX trainer's jitted step (decoder dropout off) in ``dtype``, from
    the same weights on each of ``batches``: [(images, text_in, target_y)]."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jtrba_models, "AttentionDecoder", _NoAlphaDropout)
    try:
        model = JaxTRBAModel(num_classes=len(stoi), hidden_size=64, sos_id=stoi["<SOS>"],
                             eos_id=stoi["<EOS>"], pad_id=stoi["<PAD>"], blank_id=stoi.get("<BLANK>"),
                             enc_dropout_p=0.0, cnn_stage_plan="micro", dtype=dtype, decoder_dtype=dtype)
        tx = j_build("sgd", 1.0)
        step = JT.make_train_step(model, tx, stoi["<PAD>"])
        outs = []
        for batch in batches:
            params, stats = (jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), variables[k])
                             for k in ("params", "batch_stats"))
            out = step(params, stats, tx.init(params), jax.random.PRNGKey(0), jnp.float32(SCALE), *batch)
            outs.append(jax.tree_util.tree_map(np.asarray, out))
        return outs
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def jax_steps(micro, noise):
    """{(batch, dtype): the JAX step's outputs}: a float32 step and the same
    step in float64, whose update is −S times the exact gradient."""
    variables, stoi, images, text_in, target_y = micro
    batches = {"noise": (noise, text_in, target_y), "crops": (images, text_in, target_y)}
    out = {}
    for dtype in (jnp.float32, jnp.float64):
        with jax.enable_x64(dtype == jnp.float64):
            for name, res in zip(batches, _jax_steps(variables, stoi, list(batches.values()), dtype)):
                out[name, np.dtype(dtype).name] = res
    return out


def _port_model(variables, stoi):
    model = TRBAModel(len(stoi), 64, stoi["<SOS>"], stoi["<EOS>"], stoi.get("<BLANK>"), "micro",
                      enc_dropout_p=0.0, dec_dropout_p=0.0)
    model.load_state_dict(params_from_jax(variables))
    return model


def _port_step(variables, stoi, images, text_in, target_y, enc_dropout_p=0.0):
    model = _port_model(variables, stoi)
    model.enc_dropout_p = enc_dropout_p
    params = dict(model.named_parameters())
    before = {k: p.detach().clone() for k, p in params.items()}
    tx = P.build_trba_optimizer("sgd", 1.0)
    batch = {"image": torch.from_numpy(images), "text_in": torch.from_numpy(text_in),
             "target_y": torch.from_numpy(target_y)}
    loss, _ = PT.train_step(model, tx, tx.init(params), params, batch, stoi["<PAD>"], lr_scale=SCALE,
                            generator=torch.Generator().manual_seed(0))
    return loss.item(), before, model.state_dict()


def _grad_errors(before, exact, updated):
    """{leaf: max |update/−S − g| / max |g|}, g the exact gradient."""
    out = {}
    for name, p0 in before.items():
        g = (p0.double() - exact[name].double()) / SCALE
        out[name] = ((p0 - updated[name]).double() / SCALE - g).abs().max().item() / g.abs().max().item()
    return out


# per batch: the bound on each leaf's gradient error, over the leaf's largest entry
GRAD_TOL = {"noise": 1e-4, "crops": 2e-4}


@pytest.mark.parametrize("batch", ["noise", "crops"])
def test_one_step_matches_the_jax_trainer(micro, noise, jax_steps, batch):
    variables, stoi, images, text_in, target_y = micro
    images = noise if batch == "noise" else images
    loss, before, state = _port_step(variables, stoi, images, text_in, target_y)
    (j_params, j_stats, _, j_loss), (x_params, x_stats, _, x_loss) = (
        jax_steps[batch, dt] for dt in ("float32", "float64"))
    assert x_params["cnn"]["stem_conv1"]["kernel"].dtype == np.float64
    np.testing.assert_allclose(loss, float(j_loss), rtol=1e-5)
    np.testing.assert_allclose(loss, float(x_loss), rtol=1e-5)
    want = params_from_jax({"params": j_params, "batch_stats": j_stats})
    exact = params_from_jax({"params": x_params, "batch_stats": x_stats})
    for name in want:
        if "running" in name:
            torch.testing.assert_close(state[name], want[name], rtol=1e-4, atol=1e-4, msg=name)
            torch.testing.assert_close(state[name], exact[name], rtol=1e-4, atol=1e-4, msg=name)
    for name, err in _grad_errors(before, exact, state).items():
        assert err <= GRAD_TOL[batch], (name, err)
    port_err, jax_err = (max(_grad_errors(before, exact, s).values()) for s in (state, want))
    # the JAX float32 step, whose BatchNorm variance is E[x²] − E[x]², is the farther one
    print(f"{batch}: largest leaf error over the leaf's largest entry: port {port_err:.4g}, "
          f"JAX float32 {jax_err:.4g}")
    assert port_err < jax_err
    if batch == "noise":  # the bound sees a wrong step: one encoder entry in 100 dropped
        _, _, wrong = _port_step(variables, stoi, images, text_in, target_y, enc_dropout_p=0.01)
        errs = _grad_errors(before, exact, wrong)
        assert sum(e > GRAD_TOL[batch] for e in errs.values()) > 0.9 * len(errs)


def test_non_finite_loss_zeroes_the_gradients_and_still_steps(micro, monkeypatch):
    variables, stoi, images, text_in, target_y = micro
    model = _port_model(variables, stoi)
    params = dict(model.named_parameters())
    before = {k: p.detach().clone() for k, p in params.items()}
    tx = P.build_trba_optimizer("adam", 1e-3, grad_clip=5.0)
    state = tx.init(params)
    real = PT.trba_ce_loss
    monkeypatch.setattr(PT, "trba_ce_loss", lambda *a: real(*a) * float("nan"))
    batch = {"image": torch.from_numpy(images), "text_in": torch.from_numpy(text_in),
             "target_y": torch.from_numpy(target_y)}
    loss, state = PT.train_step(model, tx, state, params, batch, stoi["<PAD>"])
    assert torch.isnan(loss)
    assert state["1"]["0"]["count"] == 1  # Adam's count advanced
    for k, p in params.items():
        assert torch.equal(p.detach(), before[k]), k


@pytest.mark.parametrize("policy", [
    ("none", "none", "none"), ("partial", "partial", "partial"), ("full", "none", "partial"),
    ("none", "full", "full"),
])
def test_freeze_policies_match_jax(policy):
    keys = ("freeze_cnn", "freeze_enc_rnn", "freeze_attention")
    cfg = dict(zip(keys, policy), exp_root="/nonexistent", exp_name="x")
    jm = JaxTRBAModel(num_classes=194, hidden_size=32, cnn_stage_plan="micro")
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 64, 3)),
                            jnp.zeros((1, 6), jnp.int32))
    jmask = JT.freeze_mask(shapes["params"], JT.Config(cfg))
    want = {".".join(str(getattr(k, "key", k)) for k in path): v
            for path, v in jax.tree_util.tree_flatten_with_path(jmask)[0]}
    got = PT.freeze_mask(TRBAModel(194, 32, cnn_stage_plan="micro"), PT.Config(cfg))
    renamed = {k.replace(".weight", ".scale") if k not in want else k: v for k, v in got.items()}
    for k, v in want.items():  # flax names: kernel / scale / bias
        name = k.replace(".kernel", ".weight").replace(".scale", ".weight")
        assert got[name] == v, k
    assert len(got) == len(want) and len(renamed) == len(want)


def test_config_exp_naming_and_resume_merge(tmp_path):
    root = tmp_path / "exp"
    (root / "exp3").mkdir(parents=True)
    (root / "other").mkdir()
    for cls in (JT.Config, PT.Config):
        assert cls({"exp_root": str(root)}).exp_dir == root / "exp4"
    old = PT.Config({"exp_root": str(root), "lr": 0.5, "hidden_size": 48}, epochs=3)
    old.save()
    for cls in (JT.Config, PT.Config):
        cfg = cls({"exp_root": str(root), "epochs": 9}, resume=str(old.exp_dir), batch_size=2)
        assert (cfg.lr, cfg.hidden_size, cfg.epochs, cfg.batch_size) == (0.5, 48, 9, 2)
        assert cfg.exp_dir == old.exp_dir and cfg.resume == str(old.exp_dir)
    assert PT.Config.DEFAULTS == JT.Config.DEFAULTS


def test_metrics_csv_header_migration(tmp_path):
    path = tmp_path / "metrics_epoch.csv"
    path.write_text("epoch,train_loss,val_acc\n0,1.5,0.25\n1,1.2,0.5\n")
    logged = []
    PT.prepare_metrics_csv(path, logged.append)
    rows = list(csv.reader(path.open()))
    assert rows[0] == PT.CSV_FIELDS and len(logged) == 1
    assert rows[1][:4] == ["0", "1.5", "", "0.25"] and rows[2][3] == "0.5"
    PT.prepare_metrics_csv(path, logged.append)  # already current: untouched
    assert len(logged) == 1


def test_more_than_one_device_raises(tmp_path, monkeypatch):
    """More cards than there are: the mesh raises (it never falls back to
    the CPU) before anything is written. The data-parallel trainer itself
    runs in tests/test_torch_mesh_train.py."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="requested 2 devices but only 1 available"):
        PT.train("a.tsv", "a", config={"exp_root": str(tmp_path), "n_devices": 2})
    assert not any(tmp_path.iterdir())


@pytest.fixture(scope="module")
def crops(tmp_path_factory):
    root = tmp_path_factory.mktemp("crops")
    return build_word_dataset(root, 12, seed=0), root


SMALL = dict(cnn_stage_plan="micro", hidden_size=32, img_h=32, img_w=64, batch_size=4,
             max_len=12, eval_beam=True, beam_size=2, seed=0)


def test_two_epochs_resume_and_a_checkpoint_both_packages_read(crops):
    (tsv, imgs), root = crops
    cfg = dict(SMALL, exp_root=str(root / "exp"), epochs=2)
    out = TRBA.train(tsv, imgs, tsv, imgs, config=cfg, device="cpu")
    exp = Path(out["exp_dir"])
    assert exp.name == "exp1" and [h["epoch"] for h in out["history"]] == [0, 1]
    ck = exp / "checkpoints"
    assert {p.name for p in ck.iterdir()} >= {"last.msgpack", "last_state.msgpack",
                                                "best_loss.msgpack", "best_acc.msgpack"}
    assert all(np.isfinite(h["train_loss"]) and 0 <= h["val_cer"] for h in out["history"])
    assert out["history"][0]["beam"] is not None

    again = TRBA.train(tsv, imgs, tsv, imgs, device="cpu",
                       config=dict(cfg, exp_name="exp1", resume=str(exp), epochs=3))
    assert [h["epoch"] for h in again["history"]] == [2]
    rows = list(csv.reader((exp / "metrics_epoch.csv").open()))
    assert [r[0] for r in rows[1:]] == ["0", "1", "2"]
    assert "resumed from" in (exp / "train.log").read_text()

    port = TRBA(ck / "best_acc.msgpack", device="cpu")
    ref = JaxTRBA(model_path=str(ck / "best_acc.msgpack"))
    assert (port.max_length, port.img_h, port.itos) == (ref.max_length, ref.img_h, ref.itos)
    rng = np.random.default_rng(3)
    images = [render_word(str(VOCAB[i]), rng) for i in range(3)]
    for mode in ("greedy", "beam"):
        got = [r["text"] for r in port.predict(images, mode=mode, beam_size=2)]
        want = [r["text"] for r in ref.predict(images, mode=mode, beam_size=2)]
        assert got == want, mode

    port.save(exp / "saved.msgpack")  # TRBA.save writes the trainer's layout
    saved, trained = (flax.serialization.msgpack_restore((exp / name).read_bytes())
                      for name in ("saved.msgpack", "checkpoints/best_acc.msgpack"))
    assert saved["itos"] == trained["itos"] and saved["config"]["max_len"] == 12
    for a, b in zip(jax.tree_util.tree_leaves(saved["params"]), jax.tree_util.tree_leaves(trained["params"])):
        np.testing.assert_array_equal(a, b)


def test_a_state_file_of_another_layout_resumes_weights_only(crops, tmp_path):
    (tsv, imgs), _ = crops
    cfg = dict(SMALL, exp_root=str(tmp_path), epochs=1, eval_beam=False)
    first = PT.train(tsv, imgs, tsv, imgs, config=cfg, device="cpu")
    exp = Path(first["exp_dir"])
    state = flax.serialization.msgpack_restore((exp / "checkpoints" / "last_state.msgpack").read_bytes())
    state["opt_state"] = {"0": {"count": np.int32(3)}}  # e.g. the JAX trainer's layout
    (exp / "checkpoints" / "last_state.msgpack").write_bytes(flax.serialization.msgpack_serialize(state))
    out = PT.train(tsv, imgs, tsv, imgs, device="cpu",
                   config=dict(cfg, exp_name=exp.name, resume=str(exp), epochs=2))
    assert [h["epoch"] for h in out["history"]] == [1]
    assert "weights-only resume" in (exp / "train.log").read_text()


def test_frozen_cnn_keeps_its_weights_but_not_its_statistics(crops, tmp_path):
    (tsv, imgs), _ = crops
    cfg = dict(SMALL, exp_root=str(tmp_path), epochs=1, eval_beam=False, freeze_cnn="full",
               freeze_attention="partial", pretrained_path=str(CKPT.parent / "missing.msgpack"))
    model = TRBAModel(194, 32, cnn_stage_plan="micro")
    from manuscript_tpu_torch.utils.weights import init_random_

    init_random_(model, 0)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    after = PT.train(tsv, imgs, tsv, imgs, config=cfg, device="cpu")["model"].state_dict()
    for k, v in before.items():
        moved = not torch.equal(after[k], v)
        if k.startswith("cnn.") and "running" not in k:
            assert not moved, k
        elif k.startswith("decoder.") and not k.startswith("decoder.gen_"):
            assert not moved, k
        elif k.startswith(("enc_rnn1.", "decoder.gen_")) or "running" in k:
            assert moved, k
    log = (Path(cfg["exp_root"]) / "exp1" / "train.log").read_text()
    assert "pretrained load failed" in log and "freeze policies active" in log


def test_bfloat16_epoch_is_finite(crops, tmp_path):
    (tsv, imgs), _ = crops
    out = PT.train(tsv, imgs, tsv, imgs, device="cpu",
                   config=dict(SMALL, exp_root=str(tmp_path), epochs=1, eval_beam=False,
                               compute_dtype="bfloat16", scheduler="cosine", optimizer="adamw",
                               weight_decay=1e-4, ss_prob=0.5))
    losses = out["history"][0]["train_losses"]
    assert len(losses) == 3 and np.all(np.isfinite(losses)) and np.isfinite(out["val_loss"])
    cfg = json.loads((Path(out["exp_dir"]) / "config.json").read_text())
    assert cfg["compute_dtype"] == "bfloat16"
