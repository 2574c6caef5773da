"""The import guard compares top-level module names whole."""

import sys
import types

from perfbench.guard import forbidden_loaded


def test_the_port_passes_and_the_jax_package_fails():
    assert forbidden_loaded(["manuscript_tpu_torch", "manuscript_tpu_torch.ops.attention_step",
                             "jaxtyping", "flaxen", "numpy"]) == []
    assert forbidden_loaded(["manuscript_tpu", "manuscript_tpu.models", "jax.numpy", "jaxlib",
                             "flax.linen"]) == ["flax.linen", "jax.numpy", "jaxlib", "manuscript_tpu",
                                                "manuscript_tpu.models"]


def test_a_stub_named_manuscript_tpu_in_sys_modules_is_found():
    import manuscript_tpu_torch  # noqa: F401

    saved = sys.modules.get("manuscript_tpu")
    try:
        sys.modules.pop("manuscript_tpu", None)
        assert "manuscript_tpu" not in forbidden_loaded()
        sys.modules["manuscript_tpu"] = types.ModuleType("manuscript_tpu")
        assert "manuscript_tpu" in forbidden_loaded()
    finally:
        if saved is None:
            sys.modules.pop("manuscript_tpu", None)
        else:
            sys.modules["manuscript_tpu"] = saved
