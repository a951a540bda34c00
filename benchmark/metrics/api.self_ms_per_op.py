"""api.self_ms_per_op: host ms in the program's `api.<op>` root spans less
the `schedule.*` spans directly under an `api.*` span of theirs (the API's
own checks, key lookup and wrapping) over the ops of the traced requests.
None where no request runs an API op."""

from benchmark.metrics import _program


def read(run):
    per = _program.requests(run)
    if per is None:
        return None
    total, seen = 0.0, False
    for spans in per:
        api = {s.span_id for s in spans if s.name.startswith("api.")}
        roots = {s.span_id for s in spans
                 if s.parent_id is None and s.span_id in api}
        for s in spans:
            if s.span_id in roots:
                total += _program.ms(s)
                seen = True
            elif (s.name.startswith("schedule.") and s.parent_id in api
                  and s.root_id in roots):
                total -= _program.ms(s)
    return total / _program.ops(run) if seen else None
