"""Traffic kinds, one module each, found by the name a cell's ``traffic`` gives.

Each module has a class ``Traffic(config, params, seed, device)`` whose constructor is the set-up (weights
and inputs from the seed, the program's objects, a warm-up of every shape the window uses) and which has
``window(seconds, prof) -> {"metrics", "attempted", "failed", "work"}``, ``release()`` (frees the program's
state), ``compare() -> {name: (value, limit)}`` (what the window produced against the reference) and
``control() -> {name: value}`` (the same numbers with the reference in TF32 in the program's place).
"""
