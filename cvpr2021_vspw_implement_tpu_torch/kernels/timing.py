"""Three clocks for one call of a kernel wrapper on the card.

A wrapper call has two costs: the host's work to enqueue the launch (argument
checks, the stream lookup, the ``ctypes`` call, ``cudaLaunchKernel``) and the
kernel's time on the device.  CUDA events around back-to-back calls read the
larger of the two, so for a kernel of a few microseconds they read the host.

* :func:`device_ms` — ``n`` calls captured into one CUDA graph and the graph
  replayed between CUDA events: the host is out of the way, and what is left
  is the device's time a launch, the graph's gap between kernels included;
* :func:`profiler_ms` — the kernels' own durations as the profiler (CUPTI)
  records them, summed over a call: the cross-check, without the gaps
  (:func:`profiler_kernels_ms`: the same, kernel by kernel);
* :func:`enqueue_ms` — the host clock over ``n`` calls with no synchronise
  inside, the median of a few such runs: what a call costs the host.

Nothing here runs at import time; every function needs a CUDA device.
"""

from __future__ import annotations

import time

import torch


def device_ms(fn, n: int = 50, warm: int = 3, replays: int = 5,
              counted=()) -> float:
    """Device time of one call of ``fn``: ``n`` calls captured into a CUDA
    graph after ``warm`` calls, the graph replayed ``replays`` times between
    CUDA events.  A wrapper reads PyTorch's current stream, so its launches
    go onto the capturing stream.  Capturing runs the Python of ``fn``, so a
    wrapper's launch counter would count the ``n`` captured calls (replays
    run no Python and count nothing): the counters of the wrappers in
    ``counted`` are put back as they were before the warm-up."""
    before = [w.launches for w in counted]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warm):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    for w, count in zip(counted, before):
        w.launches = count
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / (replays * n)


def profiler_kernels_ms(fn, n: int = 20, warm: int = 3,
                        counted=()) -> dict:
    """Device time of one call of ``fn`` by kernel as the profiler records
    it: {name of a kernel, memset or copy: its durations over ``n`` calls,
    over ``n``}, empty when the profiler reports no device time.  The
    counters of ``counted`` are put back as they were."""
    from torch.profiler import ProfilerActivity, profile

    before = [w.launches for w in counted]
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    for w, count in zip(counted, before):
        w.launches = count
    return {e.key: e.self_device_time_total / 1e3 / n
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0}


def profiler_ms(fn, n: int = 20, warm: int = 3, counted=()):
    """Device time of one call of ``fn`` as the profiler records it: the
    durations of every kernel, memset and copy on the device over ``n``
    calls, over ``n``.  None when the profiler reports no device time."""
    by_kernel = profiler_kernels_ms(fn, n, warm, counted)
    return sum(by_kernel.values()) if by_kernel else None


def enqueue_ms(fn, n: int = 200, warm: int = 3, blocks: int = 5,
               counted=()) -> float:
    """Host time of one call of ``fn``: the host clock over ``blocks`` runs
    of ``n`` calls with no synchronise inside (the device's queue drained
    before each run), the median run over ``n``: the host is shared, and
    a run that another process interrupts reads long.  The counters of
    ``counted`` are put back as they were."""
    before = [w.launches for w in counted]
    for _ in range(warm):
        fn()
    runs = []
    for _ in range(blocks):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        runs.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    for w, count in zip(counted, before):
        w.launches = count
    return 1e3 * sorted(runs)[blocks // 2] / n
