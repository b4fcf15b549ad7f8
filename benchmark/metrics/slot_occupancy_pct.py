"""slot_occupancy_pct (scheduler): the window's served tokens over the
slot-rounds the engine ran (decode rounds, counted on the device, times
the engine's slots). Each served token fills one slot for one round; an
empty slot in a round is wasted width. Batch loops only."""


def read(run):
    w = run.window
    if "walls" not in w or not w["rounds"]:
        return None
    slots = run.cfg["engine"]["n_slots"]
    return 100.0 * sum(w["tokens"]) / (w["rounds"] * slots)
