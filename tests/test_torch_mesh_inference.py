"""Pages through the port's mesh on the CPU (``parallel.make_mesh(devices=
["cpu"] * 2)``, the counterpart of the JAX package's virtual host devices),
with the committed micro checkpoints and held-out synthetic pages
(``max_words=32``, greedy), on native and device crops:

* ``Pipeline(mesh=..., batch_pages=2).process_batch`` on 3 pages (the last
  chunk short, so its last page repeats to fill the data axis) equals the
  port's run without a mesh and the JAX package's run over a 2-device mesh
  (texts equal, boxes within 1e-2 px, as ``test_torch_predict_many.py``
  holds the port to the JAX package), and ``predict`` with the mesh equals
  the page's ``process_batch`` result;
* each device of the data axis gets its own copy of both models, and
  ``batch_pages=3`` rounds up to 4;
* ``EAST.predict_batch(mesh=...)`` equals the call without a mesh;
* two gloo processes (``parallel.spawn``), each given the same pages, each
  return every page, equal to one process's (texts equal, boxes within
  1e-2 px; as the JAX package's
  ``test_two_process_fused_inference_cpu``), and ``start_batch`` there
  launches nothing (the collectives stay on the finishing thread).
"""

import numpy as np
import pytest
import torch

from manuscript_tpu_torch import Pipeline
from manuscript_tpu_torch.parallel import make_mesh, spawn
from manuscript_tpu_torch.utils.quality import load_quality_models
from manuscript_tpu_torch.utils.synthetic import eval_pages

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

KW = dict(max_words=32, mode="greedy")
# the spawned ranks import this module: the JAX package is imported only in
# the fixture that loads its models


def _pages():
    return [p for p, _ in eval_pages(3, seed=9100)]


def _summary(pages):
    """(text, polygon) of every word of every page."""
    return [[(w.text, np.asarray(w.polygon, np.float64)) for b in p.blocks for w in b.words]
            for p in pages]


def assert_same_pages(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert len(g) == len(r) > 0
        assert [t for t, _ in g] == [t for t, _ in r]
        for (_, a), (_, b) in zip(g, r):
            np.testing.assert_allclose(a, b, atol=1e-2, rtol=0)


@pytest.fixture(scope="module")
def pages():
    return _pages()


@pytest.fixture(scope="module")
def models():
    return load_quality_models("cpu")


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(devices=["cpu"] * 2)


@pytest.fixture(scope="module")
def jax_models():
    from manuscript_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from manuscript_tpu.pipeline import Pipeline as JaxPipeline
    from manuscript_tpu.utils.quality import load_quality_models as jax_models_load

    return jax_models_load(), JaxPipeline, jax_make_mesh(n_devices=2)


@pytest.mark.parametrize("crop_source", ["native", "device"])
def test_two_shards_equal_no_mesh_and_the_jax_mesh(pages, models, jax_models, mesh, crop_source):
    east, trba = models
    pipe = Pipeline(east, trba, device="cpu", batch_pages=2, crop_source=crop_source, mesh=mesh,
                    **KW)
    fused = pipe._fused
    assert fused.batch_pages == pipe.batch_pages == 2 and len(fused._replicas) == 2
    for det_model, rec_model in fused._replicas:  # fresh eval-mode copies
        assert det_model is not east.model and rec_model is not trba.model
        assert not det_model.training and not rec_model.training
    got = _summary(pipe.process_batch(pages))
    assert [c["pages"] for c in fused.chunk_timings] == [2, 1]
    plain = Pipeline(east, trba, device="cpu", batch_pages=2, crop_source=crop_source, **KW)
    assert_same_pages(got, _summary(plain.process_batch(pages)))
    assert_same_pages(_summary([pipe.predict(pages[2])]), got[2:])

    (jeast, jtrba), JaxPipeline, jax_mesh = jax_models
    jpipe = JaxPipeline(jeast, jtrba, batch_pages=2, crop_source=crop_source, mesh=jax_mesh, **KW)
    assert_same_pages(got, _summary(jpipe.process_batch(pages)))


def test_batch_pages_rounds_up_to_the_data_axis(models, mesh):
    east, trba = models
    pipe = Pipeline(east, trba, device="cpu", batch_pages=3, mesh=mesh, **KW)
    assert pipe.batch_pages == pipe._fused.batch_pages == 4


def test_east_predict_batch_with_a_mesh_equals_without(pages, models, mesh):
    east, _ = models
    want = east.predict_batch(pages[:3], batch_size=2)
    got = east.predict_batch(pages[:3], batch_size=3, mesh=mesh)  # 4 a chunk: the last page repeats
    copies = east._mesh_models[mesh]
    assert len(copies) == 2 and all(m is not east.model for m in copies)
    east.predict_batch(pages[:1], mesh=mesh)
    assert east._mesh_models[mesh] is copies  # made once per mesh
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        gq = [wd.polygon for b in g["page"].blocks for wd in b.words]
        wq = [wd.polygon for b in w["page"].blocks for wd in b.words]
        assert len(gq) == len(wq) > 0
        np.testing.assert_allclose(gq, wq, atol=1e-2, rtol=0)


def _rank_pages(rank_mesh):
    """On each of two ranks, for each crop source: the same 3 pages through
    a pipeline on the rank's mesh, and a start/finish pair → {crop source:
    ((rank 0's pages, rank 1's), what start_batch returned)} from rank 0."""
    east, trba = load_quality_models("cpu")
    pages = _pages()
    out = {}
    for crop_source in ("native", "device"):
        pipe = Pipeline(east, trba, device="cpu", batch_pages=2, crop_source=crop_source,
                        mesh=rank_mesh, **KW)
        mine = _summary(pipe.process_batch(pages))
        handle = pipe._fused.start_batch(pages[:2])
        started = handle[0]
        mine.extend(_summary(pipe._fused.finish_batch(handle)))
        theirs = [mine]
        torch.distributed.broadcast_object_list(theirs, src=1)  # rank 0 gets rank 1's
        out[crop_source] = ((mine, theirs[0]), started)
    return out


@pytest.fixture(scope="module")
def two_processes():
    return spawn(_rank_pages, make_mesh(devices=["cpu"] * 2))


@pytest.mark.parametrize("crop_source", ["native", "device"])
def test_two_processes_each_return_every_page(pages, models, two_processes, crop_source):
    (rank0, rank1), started = two_processes[crop_source]
    east, trba = models
    plain = Pipeline(east, trba, device="cpu", batch_pages=2, crop_source=crop_source, **KW)
    want = _summary(plain.process_batch(pages)) + _summary(plain.process_batch(pages[:2]))
    assert started == "prepared"
    assert_same_pages(rank0, want)  # a rank computes with one thread: sums in another order
    assert_same_pages(rank1, want)
