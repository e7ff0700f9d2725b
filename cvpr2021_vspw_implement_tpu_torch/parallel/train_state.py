"""The trainers' host-to-card path and train step (JAX counterparts:
parallel/mesh.py ``device_prefetch`` and parallel/train_state.py
``make_train_step``; reference train.py:23-126, train_clip2.py:26-126).

A collated batch is a dict of numpy arrays: ``img`` channels last ([N, H,
W, 3] or [T, N, H, W, 3]) and integer labels.  :func:`pinned_collate` makes
the loader's worker thread put each batch in page-locked memory, and
:func:`device_prefetch` copies it to the card on a side stream ``depth``
batches ahead of the consumer; the channels-last → NCHW permute runs on the
card.  The train step is forward, loss, backward, SGD update and schedule,
with BatchNorm running statistics updated by the forward.
"""

from __future__ import annotations

import collections

import numpy as np
import torch


def _host_tensors(batch: dict) -> dict:
    return {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
            for k, v in batch.items()}


def _finish(batch: dict) -> dict:
    """Tensors already on their device → the step's layout: ``img``
    channels-last → NCHW (contiguous), integer tensors int64."""
    out = {}
    for k, v in batch.items():
        if k == "img":
            v = v.movedim(-1, -3).contiguous()
        elif not v.is_floating_point():
            v = v.long()
        out[k] = v
    return out


def to_device(batch: dict, device) -> dict:
    """A collated batch → tensors on ``device``: ``img`` [..., 3, H, W]
    float32, labels int64 (blocking; :func:`device_prefetch` overlaps the
    copy with the step)."""
    return _finish({k: v.to(device) for k, v in
                    _host_tensors(batch).items()})


def pinned_collate(collate, device):
    """``collate`` whose batches are torch tensors in page-locked memory
    when ``device`` is a card (the loader's worker thread runs it; pinning
    launches nothing); ``collate`` itself elsewhere."""
    if torch.device(device).type != "cuda":
        return collate

    def pinned(items):
        return {k: v.pin_memory()
                for k, v in _host_tensors(collate(items)).items()}

    return pinned


def device_prefetch(batches, device, depth: int = 2):
    """Yield the batches of the iterable ``batches`` on ``device``, the
    copies of the next ``depth - 1`` already enqueued (JAX
    ``device_prefetch``, depth ``TPU.prefetch``).  On a card each copy is
    non-blocking on a side stream; the consumer's stream waits for that
    batch's copy event before it uses the batch, the device tensors are
    recorded on the consumer's stream, and each host tensor stays referenced
    until its copy event has completed.  Elsewhere the batches are
    :func:`to_device`'s."""
    device = torch.device(device)
    if device.type != "cuda":
        for batch in batches:
            yield to_device(batch, device)
        return
    copy_stream = torch.cuda.Stream(device)
    pending = collections.deque()    # (host, device tensors, copy event)
    inflight = []                    # (host, copy event) not yet completed

    def enqueue(batch):
        host = _host_tensors(batch)
        with torch.cuda.stream(copy_stream):
            dev = {k: v.to(device, non_blocking=True)
                   for k, v in host.items()}
            event = torch.cuda.Event()
            event.record(copy_stream)
        pending.append((host, dev, event))

    def ready():
        host, dev, event = pending.popleft()
        compute = torch.cuda.current_stream(device)
        compute.wait_event(event)
        for v in dev.values():
            v.record_stream(compute)
        inflight.append((host, event))
        inflight[:] = [(h, e) for h, e in inflight if not e.query()]
        return _finish(dev)

    try:
        for batch in batches:
            enqueue(batch)
            if len(pending) >= max(1, depth):
                yield ready()
        while pending:
            yield ready()
    finally:
        for _, event in inflight:
            event.synchronize()
        for _, _, event in pending:
            event.synchronize()


def train_step(model, optimizer, scheduler, batch, loss_fn,
               **model_kwargs) -> dict:
    """One step on ``batch`` (tensors on the model's device); ``loss_fn(outs,
    batch) -> (loss, acc)``; ``model_kwargs`` go to the model's forward
    (tdnet's ``pos_id``).  Returns {"loss", "acc"} as 0-d tensors.
    Dropout masks come from the generator that
    ``models.layers.set_dropout_generator`` gave the model."""
    model.train()
    loss, acc = loss_fn(model(batch["img"], **model_kwargs), batch)
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    # a parameter the loss does not reach still decays, as in the optax chain
    for group in optimizer.param_groups:
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
    optimizer.step()
    scheduler.step()
    return {"loss": loss.detach(), "acc": acc.detach()}
