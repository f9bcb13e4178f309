"""Environments for rollout eval (port of the JAX package's ``envs/``): the scripted FakeProcgen,
the Procgen wrapper, the gym3-faithful stub with its state codec and C++ engine, and the rollouts."""

from .fake import FakeProcgen
from .procgen import Procgen
