from sstem_tpu_torch.compat.weights import (
    discriminator_state_dict_from_jax,
    fusionnet_state_dict_from_jax,
    ifnet_state_dict_from_jax,
    load_reference,
    unet_sff_state_dict_from_jax,
    unet_sp_state_dict_from_jax,
)

__all__ = [
    "discriminator_state_dict_from_jax",
    "fusionnet_state_dict_from_jax",
    "ifnet_state_dict_from_jax",
    "load_reference",
    "unet_sff_state_dict_from_jax",
    "unet_sp_state_dict_from_jax",
]
