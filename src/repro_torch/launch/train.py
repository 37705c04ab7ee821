"""Training launcher: the fault-tolerant ``Trainer`` end to end.

    python -m repro_torch.launch.train --arch qwen1.5-0.5b --steps 200 \
        [--smoke] [--ckpt-dir DIR] [--host-id 0] [--n-hosts 1] \
        [--grad-compression] [--device cpu]

Counterpart of ``repro.launch.train``, with the same flags, plus
``--device`` (default: the card; without one it raises unless given
``--device cpu``).  ``--smoke`` gives a narrow model of the same kind for
the CPU.  Weights are random, drawn from the trainer's seeded generator;
batches are ``SyntheticLM``'s, 8 sequences of 64 tokens (the trainer's
defaults).  ``--arch`` takes the families the port trains, all on the card: dense
and MoE attention models, MLA models (MiniCPM3, through MLA's cacheless
branch), Whisper, InternVL2, xLSTM (the mLSTM through its forward and
backward kernels) and Jamba (the selective scan through its forward and
backward kernels).
"""
from __future__ import annotations

import argparse
import os
import tempfile

from ..configs import get_config
from ..configs.base import TrainConfig
from ..train import Trainer


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_launch_train"))
    ap.add_argument("--host-id", type=int, default=0)
    ap.add_argument("--n-hosts", type=int, default=1)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    tc = TrainConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                     ckpt_every=max(args.steps // 4, 1),
                     grad_compression=args.grad_compression)
    out = Trainer(cfg, tc, host_id=args.host_id, n_hosts=args.n_hosts,
                  device=args.device).run()
    print(f"final loss: {out['losses'][-1]:.4f} "
          f"(step {out['final_step']}); flags={out['straggler_flags'][:3]}")
    return out


if __name__ == "__main__":
    main()
