"""Checkpoints of the trainers (JAX counterpart: utils/checkpoint.py, which
serialises the whole TrainState): one ``torch.save`` of the trainer's state:
the model's ``state_dict`` (parameters, BatchNorm statistics), the
optimizer's state (momentum), the scheduler's position, the step, the epoch
and the state of the dropout masks' generator, as
``<dir>/model_epoch_<epoch>.pth``, or ``<dir>/<PREEMPT_PREFIX><step>.pth``
when :class:`PreemptionCheckpointer` saves mid-epoch.  The data streams are
not in it: ``FrameDataset``'s draws are keyed by (seed, epoch, index) and
need no state, while the stateful streams of ``--usetwodata``,
``--refrng`` and long clips start afresh in a resumed run, as in JAX.

JAX folds the step into its dropout key (JAX parallel/train_state.py:56);
the port draws every mask from one stateful ``torch.Generator``
(``models.layers.set_dropout_generator``), so its state is saved and
restored: a resumed run then draws the masks the uninterrupted run draws,
and the stream is the one the trainer has always drawn.
"""

from __future__ import annotations

import os
import re
import signal

import torch

#: the name of a preemption save, ``<PREEMPT_PREFIX><step>.pth``
PREEMPT_PREFIX = "preempt_"


def save_checkpoint(ckpt_dir: str, model, optimizer, scheduler, step: int,
                    epoch: int, dropout_rng: torch.Generator | None = None,
                    name: str | None = None) -> str:
    """Write ``<ckpt_dir>/<name>.pth`` (default ``model_epoch_<epoch>``)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, (name or f"model_epoch_{epoch}") + ".pth")
    torch.save({"model": model.state_dict(),
                "optimizer": optimizer.state_dict(),
                "scheduler": scheduler.state_dict(),
                "dropout_rng": (None if dropout_rng is None
                                else dropout_rng.get_state()),
                "step": step, "epoch": epoch}, path)
    return path


def load_checkpoint(path: str, model, optimizer, scheduler,
                    dropout_rng: torch.Generator | None = None
                    ) -> tuple[int, int]:
    """Restore in place (the generator too, when given and saved); returns
    (step, epoch)."""
    ckpt = torch.load(path, map_location="cpu")
    model.load_state_dict(ckpt["model"])
    optimizer.load_state_dict(ckpt["optimizer"])
    scheduler.load_state_dict(ckpt["scheduler"])
    if dropout_rng is not None and ckpt.get("dropout_rng") is not None:
        restore_rng(dropout_rng, ckpt["dropout_rng"])
    return ckpt["step"], ckpt["epoch"]


def restore_rng(generator: torch.Generator, state: torch.Tensor) -> None:
    generator.set_state(state)


class PreemptionCheckpointer:
    """Preemption-safe checkpointing (JAX ``PreemptionCheckpointer``; the
    reference has none).  SIGTERM and SIGINT set :attr:`requested`; the
    training loop reads it at each step boundary and, once it is set,
    saves ``<PREEMPT_PREFIX><step>.pth`` (:meth:`save`) and returns.  Python runs
    signal handlers on the main thread only, so a checkpointer made on
    another thread installs none.  Used as a context manager, it puts the
    original handlers back on exit."""

    def __init__(self, ckpt_dir: str):
        self.ckpt_dir = ckpt_dir
        self.requested = False
        self._orig = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._orig[sig] = signal.signal(sig, self._handler)
            except ValueError:   # not the main thread
                pass

    def _handler(self, signum, frame):
        self.requested = True

    def save(self, model, optimizer, scheduler, step: int, epoch: int,
             dropout_rng: torch.Generator | None = None) -> str:
        return save_checkpoint(self.ckpt_dir, model, optimizer, scheduler,
                               step, epoch, dropout_rng,
                               name=f"{PREEMPT_PREFIX}{step}")

    def close(self) -> None:
        """Put the handlers that were installed before back."""
        for sig, handler in self._orig.items():
            signal.signal(sig, handler)
        self._orig = {}

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def newest_of(*paths: str | None) -> str | None:
    """The most recently written of the given checkpoint paths: an epoch's
    save or a preemption's, whichever came last is where the run stopped."""
    live = [p for p in paths if p]
    return max(live, key=os.path.getmtime) if live else None


def latest_checkpoint(ckpt_dir: str, prefix: str = "model_epoch_"
                      ) -> str | None:
    """``<ckpt_dir>/<prefix><n>.pth`` with the highest n, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    best, best_n = None, -1
    pat = re.compile(re.escape(prefix) + r"(\d+)\.pth$")
    for name in os.listdir(ckpt_dir):
        m = pat.match(name)
        if m and int(m.group(1)) > best_n:
            best_n, best = int(m.group(1)), os.path.join(ckpt_dir, name)
    return best
