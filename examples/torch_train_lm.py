"""End-to-end training on the port: the ~100M-parameter qwen-family
model of ``examples/train_lm.py``, synthetic data with copy structure, the
full fault-tolerance machinery (checkpoints, restart, straggler monitor),
on the card by default.  Loss decreases within a few hundred steps.

    PYTHONPATH=src python examples/torch_train_lm.py --steps 300
    PYTHONPATH=src python examples/torch_train_lm.py --steps 300  # resumes
    PYTHONPATH=src python examples/torch_train_lm.py --steps 2 --device cpu

Without a card it raises unless given ``--device cpu``.
"""
import argparse
import os
import tempfile

from repro_torch.configs import get_config
from repro_torch.configs.base import TrainConfig
from repro_torch.train import Trainer


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    # ~100M params: the qwen config at reduced width
    cfg = get_config(args.arch).replace(
        n_layers=8, d_model=512, n_heads=8, n_kv_heads=8,
        d_ff=1408, vocab=8192, attn_block_q=128)
    print(f"params: {cfg.param_count() / 1e6:.1f}M")
    tc = TrainConfig(lr=3e-4, warmup_steps=30, total_steps=args.steps,
                     ckpt_every=100, ckpt_dir=args.ckpt_dir, seed=0)
    out = Trainer(cfg, tc, device=args.device).run(steps=args.steps)
    losses = out["losses"]
    if losses:
        k = max(len(losses) // 10, 1)
        print(f"first-{k} mean loss: {sum(losses[:k]) / k:.3f}")
        print(f"last-{k}  mean loss: {sum(losses[-k:]) / k:.3f}")
    print(f"straggler flags: {out['straggler_flags'][:3]}")
    return out


if __name__ == "__main__":
    main()
