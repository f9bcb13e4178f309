from .convert import (
    convert_reference_policy_params,
    export_reference_policy_params,
    flax_m3ae_to_torch,
    flax_path,
    flax_policy_to_torch,
    torch_policy_to_flax,
)
from .models import (
    ARPDT,
    BC,
    GCBC,
    EnsembleHeads,
    build_frozen_qpack,
    get_policy_default_config,
)
