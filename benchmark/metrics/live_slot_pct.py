"""live_slot_pct (scheduler): the window's served tokens over the
slot-rounds the engine executed in it (each executed burst's width times
its rounds, counted on the device: ``BurstStats.slot_rounds``). Unlike
``slot_occupancy_pct``, whose base is the full width, a drain downshift's
narrower bursts count at their own width. Nothing is read where no
slot-round was folded in the window (an open loop folds at its close)."""


def read(run):
    p = run.program
    if not p or not p["slot_rounds"]:
        return None
    return 100.0 * p["served_tokens"] / p["slot_rounds"]
