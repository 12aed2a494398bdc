"""The part of the tail spent inside the server: ``ServingStats``' p95 (the
handler's time from a request's arrival to its answer) over the window."""


def read(run):
    return run.counters.get("http.server_p95_ms")
