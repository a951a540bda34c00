"""The benchmark's own PBS counter: every keyswitch + PBS batch the
program runs, with its row count, by request.

It wraps the two call sites at the keyswitch-then-PBS boundary that every
classic path crosses: `integer.fused.keyswitch_then_pbs` (the single-
program chains) and `shortint.ServerKey._pbs_device` (the host, batched
and string schedules).  A chain replayed as a CUDA graph runs no Python,
so batches called while a graph is captured are kept with that graph, and
each replay adds them again: `torch.cuda.CUDAGraph.capture_begin`,
`capture_end` and `replay` are wrapped for that.  Counting is a list
append a batch; the wrappers change no argument and no result.  The
harness fails a run in which a request records no batch: the program then
reaches its PBS by a call site these wrappers do not see.
"""

from __future__ import annotations

import functools


class PbsCounter:
    def __init__(self):
        self.current = None        # row counts of the open request
        self._capturing = None     # row counts of the graph being captured
        self._graphs = {}          # id(graph) -> its captured row counts
        self._undo = []

    def _record(self, rows: int) -> None:
        if self._capturing is not None:
            self._capturing.append(rows)
        elif self.current is not None:
            self.current.append(rows)

    def install(self) -> "PbsCounter":
        import torch

        from tfhe_tpu_torch.integer import fused
        from tfhe_tpu_torch.shortint import server_key

        def patch(owner, name, make):
            orig = getattr(owner, name)
            self._undo.append((owner, name, orig))
            setattr(owner, name, functools.wraps(orig)(make(orig)))

        def ks_pbs(orig):
            def wrapper(ksk, bsk, lut, ct_big, mode=None):
                self._record(int(ct_big.shape[0]))
                return orig(ksk, bsk, lut, ct_big, mode)
            return wrapper

        def pbs_device(orig):
            def wrapper(key, data, acc):
                self._record(int(data.shape[0]))
                return orig(key, data, acc)
            return wrapper

        def capture_begin(orig):
            def wrapper(graph, *args, **kwargs):
                self._capturing = []
                return orig(graph, *args, **kwargs)
            return wrapper

        def capture_end(orig):
            def wrapper(graph, *args, **kwargs):
                out = orig(graph, *args, **kwargs)
                self._graphs[id(graph)] = self._capturing
                self._capturing = None
                return out
            return wrapper

        def replay(orig):
            def wrapper(graph, *args, **kwargs):
                if self.current is not None:
                    self.current.extend(self._graphs.get(id(graph), ()))
                return orig(graph, *args, **kwargs)
            return wrapper

        patch(fused, "keyswitch_then_pbs", ks_pbs)
        patch(server_key.ServerKey, "_pbs_device", pbs_device)
        graph_cls = torch.cuda.CUDAGraph
        patch(graph_cls, "capture_begin", capture_begin)
        patch(graph_cls, "capture_end", capture_end)
        patch(graph_cls, "replay", replay)
        return self

    def uninstall(self) -> None:
        while self._undo:
            owner, name, orig = self._undo.pop()
            setattr(owner, name, orig)

    def begin(self) -> None:
        self.current = []

    def end(self) -> list:
        rows, self.current = self.current, None
        return rows
