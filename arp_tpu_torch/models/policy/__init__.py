from .convert import flax_m3ae_to_torch, flax_policy_to_torch
from .models import (
    ARPDT,
    BC,
    GCBC,
    EnsembleHeads,
    build_frozen_qpack,
    get_policy_default_config,
)
