"""Smoke-train TRBA on synthetic rendered words: the full training stack of
the port (data pipeline, train step, validation decodes through K1,
checkpoints) end to end.

The port's counterpart of ``examples/train_synthetic.py`` (600 words, 12
epochs, hidden 128; ``--words``/``--epochs`` shrink it). Runs on the CUDA
card unless ``--cpu`` is given:

    python examples/torch_port/train_synthetic.py [workdir]
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def main(argv=None):
    from manuscript_tpu_torch.recognizers import TRBA
    from manuscript_tpu_torch.utils.device import add_cpu_flag, card_name, script_device
    from manuscript_tpu_torch.utils.synthetic import build_word_dataset

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("workdir", nargs="?", default="./synthetic_run")
    ap.add_argument("--words", type=int, default=600)
    ap.add_argument("--epochs", type=int, default=12)
    add_cpu_flag(ap)
    args = ap.parse_args(argv)
    dev = script_device(args.cpu)

    workdir = Path(args.workdir)
    tsv, img_dir = build_word_dataset(workdir / "data", n=args.words)

    t0 = time.perf_counter()
    out = TRBA.train(
        tsv,
        img_dir,
        config=dict(
            exp_root=str(workdir / "experiments"),
            exp_name="synthetic",
            max_len=12,
            hidden_size=128,
            img_h=32,
            img_w=128,
            batch_size=64,
            epochs=args.epochs,
            lr=1e-3,
            optimizer="adam",
            scheduler="cosine",
            val_size=0.15,
            early_stop=20,
        ),
        device=dev,
    )
    print(
        f"done in {time.perf_counter() - t0:.0f}s on {card_name(dev)}: "
        f"val_acc={out['val_acc']:.3f} val_loss={out['val_loss']:.3f} exp_dir={out['exp_dir']}"
    )
    return out


if __name__ == "__main__":
    main()
