"""Host ms inside DepthRunner.__call__ a request (the upload of the
view-set and the forward's launches), the mean over the window's
requests outside the profiled ones, from the harness's span around the
call."""


def read(run):
    calls = run.spans.seconds.get("call", [])
    # the span list holds the warm-up requests first
    window = calls[len(calls) - run.units:]
    ks = run.untraced()
    if not ks or len(window) != run.units:
        return None
    return 1e3 * sum(window[k] for k in ks) / len(ks)
