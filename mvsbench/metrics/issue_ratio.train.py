"""The host's seconds to issue a training step (its upload and launches,
inside train_step) over the card's seconds for it, summed over the
window's steps outside the profiled ones: near 1 or above, the host sets
the pace."""


def read(run):
    steps = run.spans.seconds.get("step", [])
    window = steps[len(steps) - run.units:]
    ks = run.untraced()
    if not ks or len(window) != run.units:
        return None
    return sum(window[k] for k in ks) / sum(run.unit_s[k] for k in ks)
