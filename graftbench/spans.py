"""Host spans around the program's layers, taken from the benchmark's side.

The benchmark's copy of the host timing that ``chip_smoke.py``'s
``Recorder`` puts around the backend's calls, widened to the morsel
pipeline: while installed, it wraps

* ``Pipeline.process`` (``repro_torch.core.runtime``): one morsel of one
  scan through every pipeline attached to it, the host NumPy engine;
* the backend's engine calls (``TorchBackend.probe_chain``,
  ``probe_visible``, ``probe``, ``probe_visible_multi``, ``segment_sum``),
  timed where they are outermost;
* the kernel wrappers the backend calls (``chain_launch`` and the three
  probes, B1-B4), counting each call and its bytes
  (``kernel_bytes``); nothing of this runs on the device.

Spans are kept only between ``open`` and ``close``: the run's window.
``uninstall`` puts every original back.
"""

from __future__ import annotations

import time
from typing import Dict, List, Tuple

from . import kernel_bytes

BACKEND_CALLS = ("probe_chain", "probe_visible", "probe", "probe_visible_multi", "segment_sum")
KERNEL_WRAPPERS = ("chain_launch", "hash_probe_lens", "hash_probe_lens64", "hash_probe_lens_multi64")


class HostSpans:
    def __init__(self):
        import repro_torch.api.backends as backends
        import repro_torch.core.runtime as runtime

        self._backends = backends
        self._runtime = runtime
        self._saved: List[Tuple[object, str, object]] = []
        self.active = False
        self._process_depth = 0
        self._backend_depth = 0
        self.reset()
        self._patch(runtime.Pipeline, "process", self._wrap_process)
        for name in BACKEND_CALLS:
            self._patch(backends.TorchBackend, name, self._wrap_backend)
        for name in KERNEL_WRAPPERS:
            self._patch(backends, name, self._wrap_kernel)

    def reset(self) -> None:
        self.process_calls = 0
        self.process_s = 0.0
        self.backend_calls = 0
        self.backend_s = 0.0
        self.backend_in_process_s = 0.0
        #: (start, end, kind) of outermost spans, kind "pipeline" or "backend"
        self.intervals: List[Tuple[float, float, str]] = []
        self.kernel_calls: Dict[str, int] = {}
        self.kernel_bytes: Dict[str, int] = {}

    def open(self) -> None:
        self.reset()
        self.active = True

    def close(self) -> None:
        self.active = False

    def uninstall(self) -> None:
        for owner, name, orig in reversed(self._saved):
            setattr(owner, name, orig)
        self._saved.clear()

    # -- wrapping --------------------------------------------------------------
    def _patch(self, owner, name: str, make) -> None:
        orig = owner.__dict__[name]
        self._saved.append((owner, name, orig))
        if isinstance(orig, staticmethod):
            setattr(owner, name, staticmethod(make(orig.__func__, name)))
        else:
            setattr(owner, name, make(orig, name))

    def _wrap_process(self, orig, name):
        spans = self

        def process(*args, **kw):
            if spans._process_depth:
                return orig(*args, **kw)
            spans._process_depth += 1
            t0 = time.perf_counter()
            try:
                return orig(*args, **kw)
            finally:
                t1 = time.perf_counter()
                spans._process_depth -= 1
                if spans.active:
                    spans.process_calls += 1
                    spans.process_s += t1 - t0
                    spans.intervals.append((t0, t1, "pipeline"))

        return process

    def _wrap_backend(self, orig, name):
        spans = self

        def call(*args, **kw):
            if spans._backend_depth:
                return orig(*args, **kw)
            spans._backend_depth += 1
            t0 = time.perf_counter()
            try:
                return orig(*args, **kw)
            finally:
                t1 = time.perf_counter()
                spans._backend_depth -= 1
                if spans.active:
                    spans.backend_calls += 1
                    spans.backend_s += t1 - t0
                    if spans._process_depth:
                        spans.backend_in_process_s += t1 - t0
                    spans.intervals.append((t0, t1, "backend"))

        return call

    def _wrap_kernel(self, orig, name):
        spans = self

        def call(*args, **kw):
            out = orig(*args, **kw)
            if spans.active:
                spans.kernel_calls[name] = spans.kernel_calls.get(name, 0) + 1
                spans.kernel_bytes[name] = (spans.kernel_bytes.get(name, 0)
                                            + kernel_bytes.count(name, args, out))
            return out

        return call

    def summary(self) -> Dict:
        return {
            "process_calls": self.process_calls,
            "process_s": self.process_s,
            "backend_calls": self.backend_calls,
            "backend_s": self.backend_s,
            "backend_in_process_s": self.backend_in_process_s,
            "kernel_calls": dict(self.kernel_calls),
            "kernel_bytes": dict(self.kernel_bytes),
        }
