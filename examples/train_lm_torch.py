"""End-to-end LM training example on the PyTorch/CUDA port (train a
model for a few hundred steps).

It trains the reduced config on the card; drop ``--smoke`` for the full
width.  Checkpoints go to ``repro_torch_train_lm`` under the temporary
directory; re-run the script and it resumes from them.  Extra arguments
override the defaults (argparse keeps the last of a repeated flag).

    PYTHONPATH=src python examples/train_lm_torch.py
    PYTHONPATH=src python -c "import sys; sys.path.insert(0, 'examples'); \\
        import train_lm_torch as t; t.main(['--steps', '3'], device='cpu')"
"""
import os
import sys
import tempfile

from repro_torch.launch.train import main as train_main


def main(argv=None, *, device=None) -> float:
    """Train and return the final loss; ``device=None`` means the card."""
    ckpt = os.path.join(tempfile.gettempdir(), "repro_torch_train_lm")
    args = [
        "--arch", "qwen1.5-0.5b", "--smoke",
        "--steps", "200", "--batch", "8", "--seq", "128",
        "--ckpt-dir", ckpt,
        "--ckpt-every", "50", "--log-every", "20",
        "--heartbeat", os.path.join(ckpt, "heartbeat.json"),
    ]
    extra = sys.argv[1:] if argv is None else list(argv)
    loss = train_main(args + extra, device=device)
    print(f"trained to loss {loss:.4f}")
    return loss


if __name__ == "__main__":
    final = main()
    if not final < 5.0:
        raise SystemExit(f"training did not make progress: {final}")
