"""The port's data-parallel train step (``parallel`` + ``train``) on the CPU:
two gloo ranks (``parallel.spawn``) each take half of a global batch, and
their step must be the port's one-device step on the whole batch.

From the committed micro checkpoints, dropout off, one step of

* TRBA, Adam and SGD (8 crops of 32×128, 4 a rank);
* EAST, ASAM + SGD with OHEM, focal geometry and ``freeze_first``, and
  RAdam + Lookahead (4 pages at 64², 2 a rank),

whose pixels are uniform over [0, 192) on rank 0's half of the batch and
over [64, 256) on rank 1's, so that per-rank statistics differ, each at a
learning rate (TRBA: its plateau scale) of S = 1e6, so that an update read
off the weights is not hidden by their rounding. Both sides run the models
in float64 (EAST's heads and loss stay float32, as in the JAX package's
float64 step): in float32 two summation orders of these gradients already
differ by up to 1e-5 of a leaf's largest entry, a BatchNorm output before a
ReLU can sit within 1e-8 of 0 (a mask the two orders set apart), and Adam's
first step divides by |g| + ε. Rank 0's loss within 1e-5 relative of the
one-device loss, its running statistics within 1e-5 of each leaf's largest
entry, and each leaf's update within 1e-5 of the leaf's largest entry of the
one-device update, plus 1e-6 of the largest entry of all leaves (EAST's conv
biases before a BatchNorm, whose gradient is 0 but for rounding; the floor of
``test_torch_train_east.py``). Rank 1 holds the same weights as rank 0. The
bound fails a wrong step: BatchNorm statistics per rank, and the mean of the
ranks' losses in place of the global ratio. Then the 2-rank TRBA step with
SGD on the uniform pixels of ``tests/test_torch_train_trba.py`` (4 crops)
against the JAX package's step over a 2-device mesh
(``tests/test_fast_device_paths.py::test_spmd_train_step_tiny``'s
placement), both in float64: within 1e-4 of each leaf's largest entry, that
file's bound. Last, ``TRBA.train`` and ``EAST.train`` with ``n_devices=2,
device="cpu"`` as one call each (the ranks started inside), equal to the
call without ``n_devices``, and ``TRBA.train`` in two processes that a
launcher's environment (``torchrun``'s) places in one group, which it joins.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from manuscript_tpu_torch import EAST, TRBA
from manuscript_tpu_torch.models.east import EASTModel
from manuscript_tpu_torch.models.layers import sync_batch_stats
from manuscript_tpu_torch.models.trba import TRBAModel
from manuscript_tpu_torch.parallel import make_mesh, shard_batch, spawn
from manuscript_tpu_torch.recognizers.charset import pack_targets
from manuscript_tpu_torch.train import east_train, optim, trba_train
from manuscript_tpu_torch.train.east_dataset import rasterize_quad_maps
from manuscript_tpu_torch.utils.synthetic import VOCAB, build_page_dataset, build_word_dataset, render_page
from manuscript_tpu_torch.utils.weights import msgpack_restore, params_from_jax

# the spawned ranks import this module: the JAX package is imported only in
# the test that runs it
QUALITY_DIR = Path(__file__).resolve().parent.parent / "manuscript_tpu" / "configs" / "quality"

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

SCALE = 1e6
TOL, FLOOR = 1e-5, 1e-6
LOSS_KW = dict(use_ohem=True, ohem_ratio=0.5, use_focal_geo=True, focal_gamma=2.0)
# (batch, optimizer, what the ranks get wrong on purpose); the model is the
# batch name's first word
CASES = [
    ("trba", "adam", None), ("trba", "sgd", None), ("trba", "sgd", "local_bn"),
    ("trba", "sgd", "mean_of_losses"), ("trba_uniform", "sgd", None),
    ("east", "asam", None), ("east", "asam", "local_bn"), ("east", "asam", "mean_of_losses"),
    ("east", "radam_lookahead", None),
]


def _inputs():
    """The micro checkpoints' variables and the global batches, numpy."""
    trba_raw = msgpack_restore(QUALITY_DIR / "trba_micro.msgpack")
    east_raw = msgpack_restore(QUALITY_DIR / "east_micro.msgpack")
    itos = [trba_raw["itos"][str(i)] for i in range(len(trba_raw["itos"]))]
    stoi = {s: i for i, s in enumerate(itos)}
    rng = np.random.default_rng(3)
    words = [str(VOCAB[int(i)]) for i in rng.integers(len(VOCAB), size=8)]
    # each rank's half of the batch is darker or lighter than the other, so
    # that per-rank statistics part from the global ones (neither near white,
    # where the stem's float32 gradient is a difference of nearly equal sums)
    dark = lambda shape: rng.integers(0, 192, shape, dtype=np.uint8)
    light = lambda shape: rng.integers(64, 256, shape, dtype=np.uint8)
    crops = np.concatenate([dark((4, 32, 128, 3)), light((4, 32, 128, 3))])
    text_in, target_y, _ = pack_targets(words, stoi, 12)
    pages, scores, geos = [], [], []
    for i in range(4):
        _, ws = render_page(rng, page_h=256, page_w=192, n_rows=3, n_cols=1)
        pages.append(dark((64, 64, 3)) if i < 2 else light((64, 64, 3)))
        s, g = rasterize_quad_maps([w["quad"] * np.float32([64 / 192, 64 / 256]) for w in ws], 64)
        scores.append(s)
        geos.append(g)
    variables = {name: {"params": raw["params"], "batch_stats": raw["batch_stats"]}
                 for name, raw in (("trba", trba_raw), ("east", east_raw))}
    # tests/test_torch_train_trba.py's batch on uniform pixels ("noise")
    words4 = [str(VOCAB[int(i)]) for i in np.random.default_rng(0).integers(len(VOCAB), size=4)]
    uniform = np.random.default_rng(1).integers(0, 256, (4, 32, 128, 3), dtype=np.uint8)
    return variables, stoi, {"trba": (crops, text_in, target_y),
                             "trba_uniform": (uniform, *pack_targets(words4, stoi, 12)[:2]),
                             "east": tuple(np.stack(a) for a in (pages, scores, geos))}


def _step(case, variables, stoi, batch, device, group=None):
    """One step of ``case`` on ``batch`` (this rank's slice under ``group``)
    → (loss, state dict on the CPU)."""
    batch_name, opt, wrong = case
    model_name = batch_name.split("_")[0]
    if model_name == "trba":
        model = TRBAModel(len(stoi), 64, stoi["<SOS>"], stoi["<EOS>"], stoi.get("<BLANK>"), "micro",
                          enc_dropout_p=0.0, dec_dropout_p=0.0)
    else:
        model = EASTModel("resnet50-micro")
    model.load_state_dict(params_from_jax(variables[model_name]))
    model.to(device, torch.float64)
    sync_batch_stats(model, None if wrong == "local_bn" else group)
    loss_group = None if wrong == "mean_of_losses" else group
    real_losses = trba_train.trba_ce_loss, east_train.east_loss
    if loss_group is None and group is not None:  # each rank's own ratio; gradients averaged
        trba_train.trba_ce_loss = lambda *a: real_losses[0](*a[:3])
        east_train.east_loss = lambda *a, group=None, **kw: real_losses[1](*a, **kw)
    try:
        if model_name == "trba":
            params = dict(model.named_parameters())
            tx = optim.build_trba_optimizer(opt, 1.0)
            t = dict(zip(("image", "text_in", "target_y"), batch))
            loss, _ = trba_train.train_step(model, tx, tx.init(params), params, t, stoi["<PAD>"],
                                            lr_scale=SCALE, group=group)
        else:
            mask = east_train.freeze_mask(model, True)
            trainable = {k: p for k, p in model.named_parameters() if mask[k]}
            tx = optim.build_east_optimizer(SCALE, 4, use_sam=opt == "asam", use_lookahead=True,
                                            grad_clip=1e12)[0]
            state = east_train.EASTTrainState(model, tx.init(trainable), None)
            loss = east_train.train_step(state, tx, trainable, *batch, use_sam=opt == "asam",
                                         sam_adaptive=True, **LOSS_KW, group=group)
    finally:
        trba_train.trba_ce_loss, east_train.east_loss = real_losses
    return loss.item(), {k: v.detach().cpu() for k, v in model.state_dict().items()}


def _rank_cases(mesh, cases):
    """On each rank: every case's step on the rank's slice → rank 0's
    {case: (loss, state)}, with whether rank 1's weights equal rank 0's."""
    variables, stoi, batches = _inputs()
    out = {}
    for case in cases:
        (piece,) = shard_batch(batches[case[0]], mesh)
        loss, state = _step(case, variables, stoi, piece, mesh.local_shards[0][1], mesh.group)
        theirs = [dict(state)]
        torch.distributed.broadcast_object_list(theirs, src=1)
        # whether rank 1 holds the same parameters, and the same running statistics
        same = [all(torch.equal(v, theirs[0][k]) for k, v in state.items() if stats == ("running" in k))
                for stats in (False, True)]
        out[case] = (loss, state, same)
    return out


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def two_ranks():
    return spawn(_rank_cases, make_mesh(devices=["cpu"] * 2), CASES)


@pytest.fixture(scope="module")
def one_device(inputs):
    variables, stoi, batches = inputs
    return {case: _step(case, variables, stoi, tuple(torch.from_numpy(a) for a in batches[case[0]]),
                        torch.device("cpu"))
            for case in CASES if case[2] is None}


def _errors(before, ref, got):
    """{leaf: max |Δ update| / (TOL · its largest update entry + FLOOR ·
    the largest of all)} over the parameters, and the same over the
    running statistics with no floor."""
    upd = {k: (ref[k] - before[k]).double() for k in before}
    floor = FLOOR * max(u.abs().max().item() for u in upd.values())
    errs = {k: ((got[k] - before[k]).double() - u).abs().max().item()
            / (TOL * u.abs().max().item() + floor) for k, u in upd.items()}
    stats = {k: (got[k] - ref[k]).abs().max().item() / (TOL * ref[k].abs().max().item())
             for k in ref if "running" in k}
    return errs, stats


def _before(inputs, batch_name):
    return {k: v.double() for k, v in params_from_jax(inputs[0][batch_name.split("_")[0]]).items()
            if "running" not in k}


@pytest.mark.parametrize("case", [c for c in CASES if c[2] is None], ids=lambda c: "-".join(c[:2]))
def test_two_ranks_take_the_one_device_step(inputs, two_ranks, one_device, case):
    loss, state, same = two_ranks[case]
    ref_loss, ref = one_device[case]
    assert all(same), "rank 1's weights differ from rank 0's"
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-5)
    errs, stats = _errors(_before(inputs, case[0]), ref, state)
    print(f"{case}: largest leaf error over the bound {max(errs.values()):.4g}, "
          f"running statistics {max(stats.values()):.4g}")
    assert max(errs.values()) <= 1.0, sorted(errs.items(), key=lambda kv: -kv[1])[:4]
    assert max(stats.values()) <= 1.0, sorted(stats.items(), key=lambda kv: -kv[1])[:4]


@pytest.mark.parametrize("case", [c for c in CASES if c[2] is not None], ids=lambda c: "-".join(c[::2]))
def test_the_bound_fails_a_step_with_per_rank_statistics_or_losses(inputs, two_ranks, one_device,
                                                                   case):
    _, state, same = two_ranks[case]
    _, ref = one_device[(case[0], case[1], None)]
    assert same[0]  # the ranks' parameters still agree: the gradients are averaged
    errs, stats = _errors(_before(inputs, case[0]), ref, state)
    over = sum(e > 1.0 for e in errs.values())
    print(f"{case}: {over} of {len(errs)} leaves over the bound, largest {max(errs.values()):.4g}")
    assert over > 0.5 * len(errs)
    if case[2] == "local_bn":
        assert max(stats.values()) > 1.0


def test_two_rank_sgd_step_matches_the_jax_two_device_mesh_step(inputs, two_ranks, one_device,
                                                                monkeypatch):
    import jax
    import jax.numpy as jnp

    import manuscript_tpu.models.trba as jtrba_models
    from manuscript_tpu.models.attention import AttentionDecoder as JaxDecoder
    from manuscript_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from manuscript_tpu.parallel.mesh import replicate as jax_replicate
    from manuscript_tpu.parallel.mesh import shard_batch as jax_shard_batch
    from manuscript_tpu.train import trba_train as JT
    from manuscript_tpu.train.optim import build_trba_optimizer as j_build

    class NoAlphaDropout(JaxDecoder):
        def _cell(self, h, c, enc, proj_enc, onehot, alpha_dropout_rng=None):
            return super()._cell(h, c, enc, proj_enc, onehot, None)

    variables, stoi, batches = inputs
    crops, text_in, target_y = batches["trba_uniform"]
    monkeypatch.setattr(jtrba_models, "AttentionDecoder", NoAlphaDropout)
    with jax.enable_x64(True):
        model = jtrba_models.TRBAModel(
            num_classes=len(stoi), hidden_size=64, sos_id=stoi["<SOS>"], eos_id=stoi["<EOS>"],
            pad_id=stoi["<PAD>"], blank_id=stoi.get("<BLANK>"), enc_dropout_p=0.0,
            cnn_stage_plan="micro", dtype=jnp.float64, decoder_dtype=jnp.float64)
        tx = j_build("sgd", 1.0)
        mesh = jax_make_mesh(n_devices=2)
        params, stats = (jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                                variables["trba"][k])
                         for k in ("params", "batch_stats"))
        opt = jax_replicate(tx.init(params), mesh)
        params, stats = jax_replicate(params, mesh), jax_replicate(stats, mesh)
        sharded = jax_shard_batch({"image": crops, "text_in": text_in, "target_y": target_y}, mesh)
        step = JT.make_train_step(model, tx, stoi["<PAD>"])
        p, s, _, j_loss = step(params, stats, opt, jax.random.PRNGKey(0), jnp.float32(SCALE),
                               sharded["image"], sharded["text_in"], sharded["target_y"])
        assert p["cnn"]["stem_conv1"]["kernel"].sharding.is_fully_replicated
        exact = params_from_jax(jax.tree_util.tree_map(np.asarray, {"params": p, "batch_stats": s}))
    loss, state, _ = two_ranks[("trba_uniform", "sgd", None)]
    np.testing.assert_allclose(loss, float(j_loss), rtol=1e-5)
    before = _before(inputs, "trba")
    err = lambda st, k: (((st[k] - before[k]).double() - (exact[k] - before[k]).double()).abs().max().item()
                         / (exact[k] - before[k]).double().abs().max().item())
    one = one_device[("trba_uniform", "sgd", None)][1]
    print("largest leaf error over the leaf's largest entry against the JAX mesh step: 2 ranks "
          f"{max(err(state, k) for k in before):.4g}, one device {max(err(one, k) for k in before):.4g}")
    for k in before:
        assert err(state, k) <= 1e-4, (k, err(state, k))
    for k in state:
        if "running" in k:
            torch.testing.assert_close(state[k], exact[k].double(), rtol=1e-4, atol=1e-4, msg=k)


def test_trba_train_with_two_devices_is_one_call(tmp_path):
    """``TRBA.train(n_devices=2, device="cpu")`` starts its two ranks and
    returns rank 0's result, which equals the call without ``n_devices``
    within 1e-5 relative (step losses, validation loss; float32, dropout
    and scheduled sampling on, drawn for the global batch; the host
    augmentation off, as its streams are per rank by design)."""
    tsv, imgs = build_word_dataset(tmp_path / "crops", 12, seed=0)
    cfg = dict(exp_root=str(tmp_path / "exp"), cnn_stage_plan="micro", hidden_size=32, img_h=32,
               img_w=64, batch_size=4, max_len=12, epochs=1, seed=0, ss_prob=0.3,
               aug_params=dict(p_ShiftScaleRotate=0.0, p_BrightnessContrast=0.0))
    one = TRBA.train(tsv, imgs, tsv, imgs, config=dict(cfg, exp_name="one"), device="cpu")
    out = TRBA.train(tsv, imgs, tsv, imgs, config=dict(cfg, n_devices=2), device="cpu")
    np.testing.assert_allclose(out["history"][0]["train_losses"], one["history"][0]["train_losses"],
                               rtol=1e-5)
    np.testing.assert_allclose(out["val_loss"], one["val_loss"], rtol=1e-5)
    assert len(out["history"]) == 1 and np.isfinite(out["val_loss"]) and 0 <= out["val_acc"] <= 1
    assert next(out["model"].parameters()).device.type == "cpu"
    exp = Path(out["exp_dir"])
    assert {p.name for p in (exp / "checkpoints").iterdir()} >= {"last.msgpack", "last_state.msgpack"}
    log = (exp / "train.log").read_text()
    assert log.count("epoch 0:") == 1  # rank 0 alone writes
    assert len((exp / "metrics_epoch.csv").read_text().splitlines()) == 2


LAUNCHED_RANK = """
import json, sys
import torch.distributed as dist
from manuscript_tpu_torch import TRBA
from manuscript_tpu_torch.parallel import mesh
from manuscript_tpu_torch.train import trba_train

def refuse(*args, **kwargs):
    raise AssertionError("a launched rank started ranks of its own")

mesh.spawn = trba_train.spawn = refuse
cfg = json.loads(sys.argv[1])
out = TRBA.train(cfg.pop("tsv"), cfg.pop("imgs"), cfg.pop("vtsv"), cfg.pop("vimgs"), config=cfg,
                 device="cpu")
print(json.dumps({"rank": dist.get_rank(), "world": dist.get_world_size(),
                  "losses": out["history"][0]["train_losses"], "val_loss": out["val_loss"]}))
"""


def test_trba_train_joins_a_launchers_group_and_spawns_nothing(tmp_path):
    """Two processes with a launcher's environment (``torchrun``'s
    ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR``/``PORT``),
    each calling ``TRBA.train(n_devices=2)``: both join that group as its
    two ranks, start no ranks of their own, take the same global steps, and
    rank 0 alone writes the log."""
    import json
    import os
    import socket
    import subprocess
    import sys

    tsv, imgs = build_word_dataset(tmp_path / "crops", 8, seed=0)
    cfg = dict(tsv=str(tsv), imgs=str(imgs), vtsv=str(tsv), vimgs=str(imgs),
               exp_root=str(tmp_path / "exp"), exp_name="launched", cnn_stage_plan="micro",
               hidden_size=32, img_h=32, img_w=64, batch_size=4, max_len=12, epochs=1, seed=0,
               n_devices=2)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    root = str(Path(__file__).resolve().parent.parent)
    procs = []
    for rank in range(2):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE="2",
                   RANK=str(rank), LOCAL_RANK=str(rank), OMP_NUM_THREADS="1",
                   PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
        procs.append(subprocess.Popen([sys.executable, "-c", LAUNCHED_RANK, json.dumps(cfg)],
                                      env=env, cwd=str(tmp_path), stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=240)
        assert p.returncode == 0, err[-3000:]
        outs.append(json.loads(out.strip().splitlines()[-1]))
    assert sorted(o["rank"] for o in outs) == [0, 1] and all(o["world"] == 2 for o in outs)
    assert len(outs[0]["losses"]) == 2 and outs[0]["losses"] == outs[1]["losses"]
    assert outs[0]["val_loss"] == outs[1]["val_loss"] and np.isfinite(outs[0]["val_loss"])
    log = (tmp_path / "exp" / "launched" / "train.log").read_text()
    assert log.count("epoch 0:") == 1


def test_east_train_with_two_devices_is_one_call(tmp_path):
    """``EAST.train(n_devices=2, device="cpu")`` as one call, equal to the
    call without ``n_devices`` within 1e-5 relative (step losses,
    validation loss; the card-resident data's jitter is drawn for the
    global batch)."""
    coco, img_dir, _ = build_page_dataset(tmp_path / "pages", 4, seed=0, page_h=256, page_w=192,
                                          n_rows=3, n_cols=1)
    kw = dict(experiment_root=str(tmp_path / "exp"), epochs=1, backbone="resnet50-micro",
              target_size=64, batch_size=2, cache_device=True, use_ema=True,
              log_tensorboard=False, device="cpu")
    one = EAST.train(img_dir, coco, img_dir, coco, model_name="one", **kw)
    out = EAST.train(img_dir, coco, img_dir, coco, n_devices=2, **kw)
    (h,) = out["history"]
    np.testing.assert_allclose(h["train_losses"], one["history"][0]["train_losses"], rtol=1e-5)
    np.testing.assert_allclose(h["val_loss"], one["history"][0]["val_loss"], rtol=1e-5)
    assert np.isfinite(h["train_loss"]) and 0 <= h["val_dice"] <= 1
    assert out["ema_params"] is not None and next(out["model"].parameters()).device.type == "cpu"
    ck = Path(out["exp_dir"]) / "checkpoints"
    assert {p.name for p in ck.iterdir()} == {"best.msgpack", "last.msgpack", "last_state.msgpack"}
