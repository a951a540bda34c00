"""schedule.replay_ms_per_op: host ms in the program's `schedule.replay`
spans (the `graph.replay()` call of a CUDA graph) over the ops of the
traced requests; None where no request replays a graph."""

from benchmark.metrics import _program


def read(run):
    per = _program.requests(run)
    if per is None:
        return None
    replays = [_program.ms(s) for spans in per for s in spans
               if s.name == "schedule.replay"]
    return sum(replays) / _program.ops(run) if replays else None
