"""Readings for the limits of a cell's check: the program, and its controls
and faults, on many seeds in one process.

    python3 perfbench/calibrate.py --workload <name> --seeds 1,2,3 \\
        --variants program,bfloat16 [--seconds 2] [--out build/readings.jsonl]

Each (variant, seed) sets the cell up, runs a short window at the cell's own
load, and prints one JSON line with every number compared. Variants:
``program`` (the program as the configuration states it), ``bfloat16`` (the
recognizer's own bfloat16 path), ``reference_bf16`` (the EAST reference in
bfloat16 put in the program's place, its checked steps alone),
``program_tf32_off`` (the program with TF32 off), ``witness_f64`` (the
program, with the EAST reference's first gradient also in float64, in the
notes), and the faults of ``fault``.
"""

import argparse
import contextlib
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from perfbench.run import _environment  # noqa: E402


@contextlib.contextmanager
def _patched(owner, name: str, make):
    inner = getattr(owner, name)
    setattr(owner, name, make(inner))
    try:
        yield
    finally:
        setattr(owner, name, inner)


def fault(variant: str):
    """The program with one fault planted, for the length of the block:

    * ``half_batch``: each training step leaves out half of its batch and
      takes the mean over the rest;
    * ``state_unchanged``: each training step returns its loss and leaves
      the weights and the optimizer state as they were;
    * ``recognize_half_batch``: a recognition call leaves out the second
      half of its strips;
    * ``step_unchanged``: each decode step returns the LSTM state it was
      given;
    * ``token_altered``: the first token of every beam search is changed
      where the beam produces it;
    * ``greedy_for_beam``: the beam search keeps one beam, which is greedy
      decoding.
    """
    if variant == "half_batch":
        from manuscript_tpu_torch.train import east_train as et

        def make(inner):
            def half(state, tx, trainable, image, score, geo, *args):
                keep = image.shape[0] - image.shape[0] // 2
                return inner(state, tx, trainable, image[:keep], score[:keep], geo[:keep], *args)
            return half
        return _patched(et, "train_step", make)
    if variant == "state_unchanged":
        import torch
        from manuscript_tpu_torch.train import east_train as et

        def make(inner):
            def unchanged(state, tx, trainable, image, score, geo, use_sam, sam_adaptive, use_ohem,
                          ohem_ratio, use_focal_geo, focal_gamma, *args):
                with torch.no_grad():
                    return et.east_train_loss(state.model, image, score, geo, use_ohem, ohem_ratio,
                                              use_focal_geo, focal_gamma)
            return unchanged
        return _patched(et, "train_step", make)
    if variant == "recognize_half_batch":
        from manuscript_tpu_torch.recognizers.trba import TRBA

        def make(inner):
            def half(self, crops, *args, **kwargs):
                return inner(self, crops[: crops.shape[0] // 2], *args, **kwargs)
            return half
        return _patched(TRBA, "recognize_tensor", make)
    if variant == "step_unchanged":
        from manuscript_tpu_torch.models import attention

        def make(inner):
            def unchanged(enc, proj_enc, h, c, *args):
                inner(enc, proj_enc, h, c, *args)
                return h, c
            return unchanged
        return _patched(attention, "attention_step", make)
    if variant == "token_altered":
        from manuscript_tpu_torch.models.attention import AttentionDecoder

        def make(inner):
            def beam(self, *args, **kwargs):
                logits, tokens = inner(self, *args, **kwargs)
                tokens = tokens.clone()
                tokens[:, 0] = (tokens[:, 0] + 1) % self.num_classes
                return logits, tokens
            return beam
        return _patched(AttentionDecoder, "beam", make)
    if variant == "greedy_for_beam":
        from manuscript_tpu_torch.models.attention import AttentionDecoder

        def make(inner):
            def one_beam(self, enc, max_len=25, beam_size=5, alpha=0.9, temperature=1.7):
                return inner(self, enc, max_len, 1, alpha, temperature)
            return one_beam
        return _patched(AttentionDecoder, "beam", make)
    return contextlib.nullcontext()


def readings(root: Path, workload: str, seed: int, variant: str, seconds: float, device):
    """Set the cell up as ``variant`` and check it → (Check, timed calls)."""
    import torch

    from perfbench import harness

    own = variant if variant in ("bfloat16", "reference_bf16", "witness_f64") else None
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = saved and variant != "program_tf32_off"
    try:
        cell = harness.load_cell(root, workload, seed, seconds, False, device, own)
        with fault(variant):
            driver = harness.load_module(cell.file("drivers", f"{cell.traffic['driver']}.py"))
            session = driver.setup(cell)
            calls = 0
            if variant != "reference_bf16":  # that control is the reference alone
                calls = harness.measure(session, cell.seconds, cell.device).calls
            session.free()
            return session.check(), calls
    finally:
        torch.backends.cudnn.allow_tf32 = saved


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--variants", default="program")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    _environment()
    import torch

    out = open(args.out, "a") if args.out else None
    for variant in args.variants.split(","):
        for seed in [int(s) for s in args.seeds.split(",")]:
            t0 = time.perf_counter()
            check, calls = readings(ROOT, args.workload, seed, variant, args.seconds, args.device)
            line = {"workload": args.workload, "variant": variant, "seed": seed, "calls": calls,
                    "correct": check.correct, "seconds": time.perf_counter() - t0,
                    "numbers": check.as_dict(), "notes": check.notes}
            print(json.dumps(line), flush=True)
            if out:
                out.write(json.dumps(line) + "\n")
                out.flush()
            gc.collect()
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
