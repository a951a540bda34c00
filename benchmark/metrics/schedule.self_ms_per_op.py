"""schedule.self_ms_per_op: host ms in the program's schedule op spans
(`schedule.fused.<op>`, `schedule.batched.<op>`) less their direct
children's (the input copies, the replay and the output clone; the PBS
batches) over the ops of the traced requests: the schedules' own host
work.  None where no request runs a schedule op span."""

from benchmark.metrics import _program


def _op_span(s):
    return s.name.startswith(_program.OP_SPANS)


def read(run):
    per = _program.requests(run)
    if per is None or not any(_op_span(s) for spans in per for s in spans):
        return None
    return (sum(_program.self_ms(spans, _op_span) for spans in per)
            / _program.ops(run))
