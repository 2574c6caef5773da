"""The port's profiler regions (``utils/profiling.annotate``) on the CPU:
free of ``record_function`` while no profiler records, nested as the
benchmark's per-layer metrics read them in a recognizer call and in an EAST
ASAM step, and ``device_split``'s launch rule on written events."""

from types import SimpleNamespace

import pytest
import torch

from manuscript_tpu_torch.models.east import EASTModel
from manuscript_tpu_torch.recognizers.trba import TRBA
from manuscript_tpu_torch.train import east_train, optim
from manuscript_tpu_torch.utils import profiling


def _refuse(*args, **kwargs):
    raise AssertionError("record_function entered with no profiler recording")


def test_annotate_enters_no_record_function_without_a_profiler(monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _refuse)
    with profiling.annotate("idle"):
        torch.ones(3).sum()
    with pytest.raises(ValueError, match="inside"):
        with profiling.annotate("raising"):
            raise ValueError("inside")
    trba = TRBA(device="cpu", allow_random_init=True, max_length=3, hidden_size=16,
                img_h=32, img_w=64, cnn_stage_plan="micro")
    trba.recognize_tensor(torch.zeros(2, 32, 64, 3, dtype=torch.uint8), "beam", beam_size=2)


def _regions(prof):
    """[(name, start, end)] of the trace's regions on the calling thread."""
    cpu = torch.autograd.DeviceType.CPU
    return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
            if e.device_type == cpu and e.is_user_annotation]


def _inside(regions, name, outer):
    """The spans of ``name`` that lie inside the span ``outer``."""
    return [r for r in regions if r[0] == name and outer[1] <= r[1] and r[2] <= outer[2]]


def _backward_of(regions, sam_pass):
    (backward,) = _inside(regions, "optim.backward", sam_pass)
    return backward


def test_a_beam_call_is_one_recognize_span_around_encode_decode_and_its_steps(tmp_path):
    trba = TRBA(device="cpu", allow_random_init=True, max_length=5, hidden_size=16,
                img_h=32, img_w=64, cnn_stage_plan="micro")
    crops = torch.randint(0, 256, (3, 32, 64, 3), dtype=torch.uint8)
    with profiling.trace(tmp_path) as prof:
        trba.recognize_tensor(crops, "beam", beam_size=2)
    regions = _regions(prof)
    (call,) = [r for r in regions if r[0] == "trba.recognize"]
    assert len(_inside(regions, "trba.encode", call)) == 1
    (decode,) = _inside(regions, "trba.decode", call)
    assert len(_inside(regions, "beam.step", decode)) == trba.max_length == 5
    assert len([r for r in regions if r[0] == "beam.step"]) == 5


def test_an_asam_step_nests_its_passes_perturbation_restore_and_update(tmp_path):
    torch.manual_seed(0)
    model = EASTModel("resnet50-micro")
    mask = east_train.freeze_mask(model, True)
    trainable = {k: p for k, p in model.named_parameters() if mask[k]}
    tx, _ = optim.build_east_optimizer(1e-3, 2, use_sam=True)
    state = east_train.EASTTrainState(model, tx.init(trainable), None)
    image = torch.randint(0, 256, (2, 64, 64, 3), dtype=torch.uint8)
    score = (torch.rand(2, 16, 16) > 0.7).float()
    geo = torch.randn(2, 16, 16, 8) * 4
    with profiling.trace(tmp_path) as prof:
        east_train.train_step(state, tx, trainable, image, score, geo)
    regions = _regions(prof)
    (step,) = [r for r in regions if r[0] == "east.step"]
    (first,) = _inside(regions, "sam.first_pass", step)
    (second,) = _inside(regions, "sam.second_pass", step)
    (update,) = _inside(regions, "east.update", step)
    assert first[2] <= second[1] <= second[2] <= update[1]
    for sam_pass in (first, second):
        (forward,) = _inside(regions, "east.forward", sam_pass)
        assert forward[2] <= _backward_of(regions, sam_pass)[1]
    (perturb,) = _inside(regions, "sam.perturb", first)
    assert _backward_of(regions, first)[2] <= perturb[1]
    (restore,) = _inside(regions, "sam.restore", second)
    assert _backward_of(regions, second)[2] <= restore[1]
    assert not _inside(regions, "sam.perturb", second) and not _inside(regions, "sam.restore", first)
    # on the CPU the backward runs on the calling thread: its nodes are there
    assert profiling.autograd_threads(prof.events())


def test_launched_in_takes_the_span_thread_and_autograd_workers_inside_the_span():
    launches = [("main", 1.0, "before"), ("main", 2.0, "own"), ("autograd", 3.0, "backward"),
                ("loader", 4.0, "other thread"), ("main", 5.0, "at the end"), ("main", 6.0, "after")]
    assert profiling.launched_in(("main", 2.0, 5.0), launches, {"autograd"}) == [
        "own", "backward", "at the end"]
    assert profiling.launched_in(("main", 2.0, 5.0), launches, set()) == ["own", "at the end"]
    assert profiling.launched_in(("main", 7.0, 9.0), launches, {"autograd"}) == []
    events = [SimpleNamespace(name="autograd::engine::evaluate_function: MulBackward0", thread=7),
              SimpleNamespace(name="aten::mul", thread=1)]
    assert profiling.autograd_threads(events) == {7}


def _event(name, thread, start, end, device="cpu", annotation=False, kernels=(), id=None):
    dt = torch.autograd.DeviceType.CUDA if device == "cuda" else torch.autograd.DeviceType.CPU
    return SimpleNamespace(name=name, thread=thread, device_type=dt, is_user_annotation=annotation,
                           time_range=SimpleNamespace(start=start, end=end), kernels=list(kernels),
                           id=id)


def test_device_split_counts_a_backward_launched_on_autograds_thread():
    """A region around ``autograd.grad`` on thread 1 holds the kernels that
    the engine's worker (thread 2) launched while it waited; a kernel of a
    third thread in the same interval is not the region's."""
    k = lambda name, us: SimpleNamespace(name=name, device=0, duration=us)
    events = [
        _event("optim.backward", 1, 100, 200, annotation=True),
        _event("aten::empty", 1, 105, 106, kernels=[k("fill", 2.0)]),
        _event("autograd::engine::evaluate_function: MulBackward0", 2, 110, 150),
        _event("aten::mul", 2, 111, 120, kernels=[k("mul_kernel", 10.0)]),
        _event("aten::add", 3, 130, 131, kernels=[k("loader_kernel", 5.0)]),
        _event("aten::sum", 1, 210, 220, kernels=[k("sum_kernel", 4.0)]),
        _event("fill", 0, 106, 108, device="cuda"),
        _event("mul_kernel", 0, 121, 131, device="cuda"),
        _event("loader_kernel", 0, 132, 137, device="cuda"),
        _event("sum_kernel", 0, 221, 225, device="cuda"),
        _event("optim.backward", 0, 100, 200, device="cuda", annotation=True),
    ]
    split = profiling.device_split(SimpleNamespace(events=lambda: events))
    assert split["regions"] == {"optim.backward": {"count": 1, "launches": 2, "device_ms": 0.012}}
    assert split["launches"] == 4


def test_device_split_places_a_kernel_no_operator_launched_at_its_launch_call():
    """A hand-written kernel launched through ctypes inside a region but
    outside any operator: no operator holds it, so its CUDA launch call
    (the same correlation id) places it; one launched after the region is
    not the region's, and a kernel an operator holds counts once."""
    k = lambda name, us: SimpleNamespace(name=name, device=0, duration=us)
    events = [
        _event("east.update", 1, 100, 200, annotation=True, id=1),
        _event("optim.multi_tensor", 1, 110, 150, annotation=True, id=2),
        _event("aten::fill_", 1, 112, 113, kernels=[k("fill", 2.0)], id=5),
        _event("cudaLaunchKernel", 1, 112.5, 112.8, id=9),
        _event("cudaLaunchKernel", 1, 120, 121, id=16),
        _event("cudaLaunchKernel", 1, 250, 251, id=17),
        _event("fill", 0, 114, 116, device="cuda", id=9),
        _event("update_kernel", 0, 122, 130, device="cuda", id=16),
        _event("update_kernel", 0, 252, 260, device="cuda", id=17),
        _event("optim.multi_tensor", 0, 122, 130, device="cuda", annotation=True, id=2),
    ]
    split = profiling.device_split(SimpleNamespace(events=lambda: events))
    for region in ("east.update", "optim.multi_tensor"):
        assert split["regions"][region] == {"count": 1, "launches": 2, "device_ms": 0.010}
    assert split["launches"] == 3


def test_a_trocr_call_nests_encode_decode_cross_kv_and_a_step_a_token(tmp_path):
    from manuscript_tpu_torch.models.trocr import TrOCRConfig
    from manuscript_tpu_torch.recognizers import TrOCR

    config = TrOCRConfig(image_size=32, patch_size=8, enc_hidden=32, enc_layers=1, enc_heads=4,
                         enc_mlp=64, d_model=32, dec_layers=1, dec_heads=4, dec_ffn=64, vocab_size=50,
                         max_position_embeddings=16)
    rec = TrOCR(device="cpu", allow_random_init=True, max_length=4, config=config)
    lines = torch.randint(0, 256, (2, 32, 32, 3), dtype=torch.uint8)
    with profiling.trace(tmp_path) as prof:
        rec.recognize_tensor(lines, "beam", beam_size=2)
    regions = _regions(prof)
    (call,) = [r for r in regions if r[0] == "trocr.recognize"]
    assert len(_inside(regions, "trocr.encode", call)) == 1
    (decode,) = _inside(regions, "trocr.decode", call)
    assert len(_inside(regions, "trocr.cross_kv", decode)) == 1
    assert len(_inside(regions, "trocr.step", decode)) == rec.max_length == 4
    assert len([r for r in regions if r[0].startswith("trocr.")]) == 1 + 1 + 1 + 1 + 4
