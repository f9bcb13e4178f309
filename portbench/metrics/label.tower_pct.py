"""label.tower_pct: The image tower's time over the labeling window (%): the change in the reward engine's
``tower_seconds`` counter across the window (on the card the device time between two CUDA timing events around
each chunk's tower call, the resize and the copies outside them), over the window.  None on a program without
the counter."""


def read(record: dict):
    tower = record["work"].get("tower_s")
    return None if tower is None else 100.0 * tower / record["window_s"]
