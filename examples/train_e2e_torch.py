"""End-to-end training driver example on the port.

The PyTorch twin of ``examples/train_e2e.py``. The default runs the
xLSTM-125M *smoke* config for a quick demonstration; ``--full`` trains the
real 125M-parameter configuration at seq 1024 with 2 microbatches:

    PYTHONPATH=src python examples/train_e2e_torch.py              # card
    PYTHONPATH=src python examples/train_e2e_torch.py --device cpu
    PYTHONPATH=src python examples/train_e2e_torch.py --full --steps 300

A thin veneer over ``repro_torch.launch.train``: checkpointing, NaN
skip-batch, preemption save and resume all come from the runtime driver.
Interrupt it (Ctrl-C) and run it again: it resumes from its last
checkpoint. Its checkpoints go to their own directory, not the JAX
example's: both packages load each other's checkpoints, so a shared one
would make a run of one package resume from the other's state. Any flag of
the train CLI (``--steps``, ``--ckpt-dir``, ``--device``, ...) overrides
a default.
"""

from __future__ import annotations

import os
import sys
import tempfile

from repro_torch.launch import train as train_cli

CKPT_DIR = os.path.join(tempfile.gettempdir(), "repro_torch_train_e2e")


def main(argv=None) -> dict:
    """Run the train CLI with the example's defaults; return what it
    printed: ``start``, ``end``, the first and last ``loss``."""
    args = list(sys.argv[1:] if argv is None else argv)
    full = "--full" in args
    if full:
        args.remove("--full")
    defaults = ["--arch", "xlstm-125m", "--ckpt-dir", CKPT_DIR,
                "--ckpt-every", "25"]
    if not full:
        defaults += ["--smoke", "--steps", "60", "--batch", "8",
                     "--seq", "128"]
    else:
        defaults += ["--steps", "300", "--batch", "8", "--seq", "1024",
                     "--microbatches", "2"]
    # argparse keeps the last occurrence: the caller's flags win
    res = train_cli.main(defaults + args)
    losses = [e["loss"] for e in res.events if e.get("event") == "step"]
    return {"start": res.start, "end": res.end,
            "loss": (losses[0], losses[-1]) if losses else None}


if __name__ == "__main__":
    main()
