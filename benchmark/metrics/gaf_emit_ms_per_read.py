"""Host ms of the harness's ``emit_record`` span (``alignment_to_gaf`` and
the write, as ``lasagna``'s ``emit_record``) per read of the window."""


def read(run):
    spans = run.spans.get("emit_record")
    return sum(spans) * 1e3 / run.reads if spans else None
