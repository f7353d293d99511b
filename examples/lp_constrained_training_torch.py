"""End-to-end training example with the paper's solver inside the
optimizer, on the PyTorch/CUDA port: every step solves a batch of
per-parameter-block 2-D LPs that pick a trust-region-safe update scale
(``repro_torch.optim.lp_clip``; on the card the batch goes through the
CUDA kernel).  Extra arguments override the defaults of both runs.

    PYTHONPATH=src python examples/lp_constrained_training_torch.py
    PYTHONPATH=src python -c "import sys; sys.path.insert(0, 'examples'); \\
        import lp_constrained_training_torch as t; \\
        t.main(['--steps', '3'], device='cpu')"
"""
import sys

from repro_torch.launch.train import main as train_main


def main(argv=None, *, device=None) -> tuple:
    """Train plain AdamW, then LP-clipped AdamW; returns both final
    losses.  ``device=None`` means the card."""
    extra = sys.argv[1:] if argv is None else list(argv)
    common = ["--arch", "qwen1.5-0.5b", "--smoke", "--steps", "40",
              "--batch", "8", "--seq", "64", "--lr", "3e-3",
              "--log-every", "10"]
    print("== baseline (plain AdamW) ==")
    loss_a = train_main(common + extra, device=device)
    print("== LP-constrained updates (batch 2-D LP per block/step) ==")
    loss_b = train_main(common + ["--lp-clip"] + extra, device=device)
    print(f"final losses: adamw={loss_a:.4f}  lp-clipped={loss_b:.4f}")
    print("(at an aggressive lr the LP trust region keeps early steps "
          "bounded; lp_s1 < 1 in the logs shows the constraint binding)")
    return loss_a, loss_b


if __name__ == "__main__":
    main()
