"""decisions_per_s: tasks whose placement the store shows committed in
the window (preassigned tasks confirmed and tasks placed), over the
window's seconds, store writes and watch feed included."""


def read(rec):
    return rec.placed / rec.window_s if rec.window_s > 0 else None
