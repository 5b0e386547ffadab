"""The ``device_loop`` epoch: one training step captured as a CUDA graph,
replayed once a step.

The port of the JAX package's fused epochs (``xgnn_tpu/engine/engine.py``,
``_make_fused_epoch`` and ``_train_epoch_fused``; the multi-card engine's
``_make_mc_fused_epoch`` and ``_train_epoch_fused``,
``xgnn_tpu/engine/multi_engine.py:95-122, 765-837``), which run a whole
epoch as one ``lax.scan`` program.  Here the engine's step
(``engine._fused_step``: for the single store sample, label gather,
forward, backward, Adam with the skip on overflow; for the collocated
multi-card engine its rank's fused step, the NCCL collectives of the
owner exchange and of the gradients' reduction among them) is captured
once over static buffers, and each step of an epoch is one ``replay()``:
the host enqueues no kernel of the step.

The buffers: the epoch's seeds ``(steps, batch_size)`` int32 and valid
counts ``(steps,)``, uploaded once an epoch; the step index, an int64 on
the card that the step reads its row with and advances; the epoch's stats
``(rows, steps)`` (loss, accuracy, overflow flag, input nodes, and the
multi-card engine's sanity flags when ``sanity_check`` is on), which the
step writes at its row and the host pulls once an epoch.  The sampling and
the dropout generators are registered with the graph and re-seeded before
each replay with the seeds the host loop gives the same step, so a replay
draws the host loop's uniforms and masks.  An overflowed step is skipped on
the card, as in the host loop; the engine then grows its capacities and
drops the graph, and the next epoch captures again.

Before the capture, one eager step on the capturing stream loads every
kernel, makes K3's state for that stream (``ops/unique.state``) and, on the
multi-card engine, runs each collective once on the communicator; the
step's params, moments and count are put back after it.  A failed capture
raises.  The step runs the host loop's own pieces (``Engine._extract`` and
``Engine._train``; the multi-card engine's ``step_fn``).  NCCL's watchdog
thread queries the events of earlier collectives, so the multi-card engine
captures in ``thread_local`` error mode, which lets another thread's calls
go on during the capture.  The wrappers' launch counters count in Python:
the warm-up step and the captured one each add an eager step's counts, and
a replay adds nothing (what a replay ran on the card is read from the
profiler's records).  On the CPU the same step runs uncaptured, once a
step, from the same buffers.
"""

from __future__ import annotations

import contextlib
import time
from typing import Sequence

import numpy as np
import torch

from .. import constants as C


class FusedEpoch:
    """The captured step of ``engine`` for epochs of ``steps`` steps, its
    stats ``rows`` deep (``engine._fused_step`` returns a column of
    them)."""

    def __init__(self, engine, steps: int, rows: int = 4,
                 capture_error_mode: str = "global"):
        self.engine = engine
        self.steps = steps
        dev = engine.device
        batch = engine.config.batch_size
        self.seeds = torch.full((steps, batch), C.EMPTY_KEY,
                                dtype=torch.int32, device=dev)
        self.num_valid = torch.zeros(steps, dtype=torch.int32, device=dev)
        self.step = torch.zeros(1, dtype=torch.int64, device=dev)
        self.stats = torch.zeros((rows, steps), dtype=torch.float32,
                                 device=dev)
        self.capture_error_mode = capture_error_mode
        self.sample_gen = torch.Generator(device=dev)
        self.dropout_gen = torch.Generator(device=dev)
        self.graph = None
        self.stream = None
        self.capture_s = 0.0
        if dev.type == "cuda":
            self._capture()

    def _train_state(self) -> list:
        eng = self.engine
        return (list(eng.model.parameters()) + eng.opt.mu + eng.opt.nu
                + [eng.opt.count])

    def _step(self):
        """The engine's step at ``self.step``, its stats written there."""
        i = self.step
        seeds = self.seeds.index_select(0, i).reshape(-1)
        num_valid = self.num_valid.index_select(0, i).reshape(())
        row = self.engine._fused_step(seeds, num_valid, self.sample_gen,
                                      self.dropout_gen)
        self.stats.index_copy_(1, i, row[:, None])
        self.step.add_(1)

    def _capture(self):
        dev = self.engine.device
        t0 = time.perf_counter()
        state = self._train_state()
        saved = [t.detach().clone() for t in state]
        self.stream = torch.cuda.Stream(dev)
        self.stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(self.stream):
            self._step()
            with torch.no_grad():
                for t, v in zip(state, saved):
                    t.copy_(v)
            self.step.zero_()
            self.stats.zero_()
        torch.cuda.synchronize(dev)
        del saved
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.sample_gen)
        graph.register_generator_state(self.dropout_gen)
        with torch.cuda.graph(graph, stream=self.stream,
                              capture_error_mode=self.capture_error_mode):
            self._step()
        torch.cuda.synchronize(dev)
        self.graph = graph
        self.capture_s = time.perf_counter() - t0

    def run(self, seeds: np.ndarray, num_valid: np.ndarray,
            gen_seeds: Sequence) -> np.ndarray:
        """One epoch: ``seeds`` ``(steps, batch_size)`` and ``num_valid``
        ``(steps,)`` uploaded once, then each step with its generators
        seeded from ``gen_seeds[step]`` (a (sampling, dropout) pair).
        Returns the ``(rows, steps)`` stats, pulled once."""
        dev = self.engine.device
        ctx = contextlib.nullcontext()
        if self.stream is not None:
            self.stream.wait_stream(torch.cuda.current_stream(dev))
            ctx = torch.cuda.stream(self.stream)
        with ctx:
            for buf, host in ((self.seeds, seeds), (self.num_valid,
                                                    num_valid)):
                host = torch.from_numpy(host)
                if self.stream is not None:
                    # from pinned memory the copy is queued, not waited on
                    host = host.pin_memory()
                buf.copy_(host, non_blocking=True)
            self.step.zero_()
            for sample_seed, dropout_seed in gen_seeds:
                self.sample_gen.manual_seed(sample_seed)
                self.dropout_gen.manual_seed(dropout_seed)
                if self.graph is not None:
                    self.graph.replay()
                else:
                    self._step()
        if self.graph is not None:
            torch.cuda.current_stream(dev).wait_stream(self.stream)
        # a copy: on the CPU ``cpu()`` would return the buffer itself
        return self.stats.to("cpu", copy=True).numpy()
