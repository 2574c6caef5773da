"""Probe: does int8 matrix multiplication beat bfloat16 on this card at the
convolution shapes of the two CNNs?

The port's counterpart of ``examples/int8_probe.py``, the same question
asked of this card. Each convolution is taken as the GEMM of its im2col
form, M = N·H_out·W_out rows, K = C_in·k·k, N = C_out: bfloat16 through
cuBLAS (``a @ b``) against int8 with int32 accumulation
(``torch._int_mm``, cuBLASLt), and the bfloat16 convolution itself through
cuDNN for context; plus a 4096³ matmul control. H100 SXM's dense peaks are
989 TFLOP/s in bf16 and 1979 TOP/s in int8 (NVIDIA's data sheet, at 700 W).
Times are CUDA events around 20 calls (``utils.profiling.call_ms``). It
times library kernels only and claims nothing. One JSON line per shape,
naming the card. ``MANUSCRIPT_TPU_BENCH_SMOKE=1`` shrinks every shape;
``--cpu`` runs on the CPU (host-clock ms):

    python examples/torch_port/int8_probe.py
"""

import argparse
import json
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

# (name, n, h, w, c_in, c_out, k, stride): TRBA SEResNet31's hot shapes (64
# crops of 64×256 through its stages) and EAST resnet50's (a 1280² page)
SHAPES = (
    ("trba_stage1 3x3 64x256x128->256 s2", 64, 64, 256, 128, 256, 3, 2),
    ("trba_stage2 3x3 32x128x256", 64, 32, 128, 256, 256, 3, 1),
    ("trba_stage3 3x3 16x64x512 s2", 64, 16, 64, 256, 512, 3, 2),
    ("trba_stage3b 3x3 16x64x512", 64, 16, 64, 512, 512, 3, 1),
    ("east_layer1 1x1 320^2 64->256", 1, 320, 320, 64, 256, 1, 1),
    ("east_layer1 3x3 320^2 64->64", 1, 320, 320, 64, 64, 3, 1),
    ("east_layer3 3x3 80^2 256->256", 1, 80, 80, 256, 256, 3, 1),
)


def main(argv=None):
    import torch
    import torch.nn.functional as F

    from manuscript_tpu_torch.utils.device import add_cpu_flag, card_name, script_device
    from manuscript_tpu_torch.utils.profiling import call_ms

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_cpu_flag(ap)
    args = ap.parse_args(argv)
    smoke = os.environ.get("MANUSCRIPT_TPU_BENCH_SMOKE") == "1"
    dev = script_device(args.cpu)
    device = card_name(dev)
    calls = 2 if smoke else 20
    gen = torch.Generator().manual_seed(0)
    lines = []

    def emit(line):
        line["device"] = device
        print(json.dumps(line), flush=True)
        lines.append(line)

    def gemm_pair(m, k, n):
        """(bf16 ms, int8 ms) of an (m, k) × (k, n) product."""
        # the weights (n, k) row-major, so the right operand is column-major,
        # as in a linear layer
        a_bf = torch.randn(m, k, generator=gen).to(dev, torch.bfloat16)
        w_bf = torch.randn(n, k, generator=gen).to(dev, torch.bfloat16)
        a_i8 = torch.randint(-127, 127, (m, k), generator=gen, dtype=torch.int8).to(dev)
        w_i8 = torch.randint(-127, 127, (n, k), generator=gen, dtype=torch.int8).to(dev)
        return (call_ms(lambda: a_bf @ w_bf.t(), dev, calls),
                call_ms(lambda: torch._int_mm(a_i8, w_i8.t()), dev, calls))

    with torch.inference_mode():
        for name, n, h, w, cin, cout, k, stride in SHAPES:
            if smoke:  # torch._int_mm takes more than 16 rows
                n, h, w = 1, max(16, h // 8), max(16, w // 8)
                cin, cout = max(16, cin // 8), max(16, cout // 8)
            m, kk = n * (h // stride) * (w // stride), cin * k * k
            t_bf, t_i8 = gemm_pair(m, kk, cout)
            x = torch.randn(n, cin, h, w, generator=gen).to(dev, torch.bfloat16)
            wt = torch.randn(cout, cin, k, k, generator=gen).to(dev, torch.bfloat16)
            t_conv = call_ms(lambda: F.conv2d(x, wt, stride=stride, padding=k // 2), dev, calls)
            flops = 2 * m * kk * cout
            emit({"shape": name, "gemm": [m, kk, cout], "bf16_gemm_ms": round(t_bf, 5),
                  "int8_gemm_ms": round(t_i8, 5), "bf16_conv_ms": round(t_conv, 5),
                  "bf16_tflops": round(flops / t_bf / 1e9, 3),
                  "int8_tops": round(flops / t_i8 / 1e9, 3),
                  "int8_speedup": round(t_bf / t_i8, 4)})
        side = 256 if smoke else 4096
        t_bf, t_i8 = gemm_pair(side, side, side)
        flops = 2 * side**3
        emit({"shape": f"matmul{side}", "gemm": [side, side, side], "bf16_gemm_ms": round(t_bf, 5),
              "int8_gemm_ms": round(t_i8, 5), "bf16_tflops": round(flops / t_bf / 1e9, 3),
              "int8_tops": round(flops / t_i8 / 1e9, 3), "int8_speedup": round(t_bf / t_i8, 4)})
    return lines


if __name__ == "__main__":
    main()
