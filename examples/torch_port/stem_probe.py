"""Probe: EAST's ResNet stem convolution (7×7/2 on a 3-channel 1280² page)
against its space-to-depth form (4×4/1 on 640²×12), bfloat16 through cuDNN.

The port's counterpart of ``examples/stem_probe.py``, the same question
asked of this card. The space-to-depth rewrite

    y = conv7x7_s2_p3(x)                    # 3×1280×1280  → 64×640×640
      = conv4x4_s1_p(2,1)(s2d_2x2(x))       # 12×640×640   → 64×640×640

pads the 7×7 kernel to 8×8 with one zero row and column at the top and left
and folds each 2×2 block of pixels into channels (order: row in block,
column in block, channel), the same multiply-adds with four times the
contraction depth. The probe checks the two equal in float32 (relative
error below 1e-5), then times both in bfloat16 (``utils.profiling.
graph_time_ms``) and, for context, EAST's whole forward (resnet50, random
weights from a seed; ``call_ms``, CUDA events around 10 forwards). It times library convolutions only. One JSON line
each, naming the card. ``MANUSCRIPT_TPU_BENCH_SMOKE=1`` runs 128² and
resnet50-tiny; ``--cpu`` runs on the CPU (host-clock ms):

    python examples/torch_port/stem_probe.py
"""

import argparse
import json
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def s2d(x, b: int = 2):
    """NCHW space-to-depth: (N, C, H, W) → (N, b·b·C, H/b, W/b), channels
    ordered (row in block, column in block, channel)."""
    n, c, h, w = x.shape
    x = x.reshape(n, c, h // b, b, w // b, b).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(n, b * b * c, h // b, w // b)


def fold_kernel(k, b: int = 2):
    """(O, C, 7, 7) → zero-pad to 8×8 at the top and left → (O, 4C, 4, 4),
    in ``s2d``'s channel order."""
    import torch.nn.functional as F

    k8 = F.pad(k, (1, 0, 1, 0))
    o, c, kh, kw = k8.shape
    k8 = k8.reshape(o, c, kh // b, b, kw // b, b).permute(0, 3, 5, 1, 2, 4)
    return k8.reshape(o, b * b * c, kh // b, kw // b)


def conv_stem(x, k):
    import torch.nn.functional as F

    return F.conv2d(x, k, stride=2, padding=3)


def conv_s2d(x2, k2):
    import torch.nn.functional as F

    return F.conv2d(F.pad(x2, (2, 1, 2, 1)), k2)


def main(argv=None):
    import numpy as np
    import torch

    from manuscript_tpu_torch.models.east import EASTModel
    from manuscript_tpu_torch.utils.device import add_cpu_flag, card_name, script_device
    from manuscript_tpu_torch.utils.profiling import call_ms, graph_time_ms
    from manuscript_tpu_torch.utils.weights import init_random_

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_cpu_flag(ap)
    args = ap.parse_args(argv)
    smoke = os.environ.get("MANUSCRIPT_TPU_BENCH_SMOKE") == "1"
    dev = script_device(args.cpu)
    device, cuda = card_name(dev), dev.type == "cuda"
    timer = graph_time_ms if cuda else (lambda fn: call_ms(fn, dev, calls=3))
    size = 128 if smoke else 1280
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((1, 3, size, size), dtype=np.float32)).to(dev)
    k = torch.from_numpy(rng.standard_normal((64, 3, 7, 7), dtype=np.float32) * 0.05).to(dev)
    lines = []

    def emit(line):
        line["device"] = device
        print(json.dumps(line), flush=True)
        lines.append(line)

    # equal in float32 (TF32 off: both sides round alike)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    with torch.inference_mode():
        y_a, y_b = conv_stem(x, k), conv_s2d(s2d(x), fold_kernel(k))
    torch.backends.cudnn.allow_tf32 = tf32
    err = float((y_a - y_b).abs().max() / (y_a.abs().max() + 1e-9))
    emit({"check": "s2d_equivalence", "rel_err": err, "shape": list(y_a.shape)})
    if not err < 1e-5:
        raise RuntimeError(f"space-to-depth stem differs from the 7x7/2 stem: {err}")

    xb, kb = x.to(torch.bfloat16), k.to(torch.bfloat16)
    x2, k2 = s2d(xb).contiguous(), fold_kernel(kb).contiguous()
    flops = 2 * 64 * (size // 2) ** 2 * 3 * 49
    with torch.inference_mode():
        for name, fn in (("stem_conv_7x7s2", lambda: conv_stem(xb, kb)),
                         ("stem_conv_s2d_4x4s1", lambda: conv_s2d(x2, k2))):
            ms = timer(fn)
            emit({"program": name, "ms": round(ms, 5),
                  "tflops_useful": round(flops / ms / 1e9, 3)})

        backbone = "resnet50-tiny" if smoke else "resnet50"
        model = init_random_(EASTModel(backbone), 0).to(device=dev, dtype=torch.bfloat16).eval()
        page = xb.permute(0, 2, 3, 1).contiguous()
        emit({"program": "east_forward_full", "backbone": backbone,
              "ms": round(call_ms(lambda: model(page), dev, calls=10), 5)})
    return lines


if __name__ == "__main__":
    main()
