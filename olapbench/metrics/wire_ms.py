"""wire_ms: mean exclusive time of each request's root `query` span: the
server's and the wire's own work (server, models/wire: decode, envelope,
response), outside every child span."""


def read(run):
    own = [root.ms - sum(c.ms for c in root.children) for _, root in run.traced()]
    return sum(own) / len(own) if own else None
