from .jax_params import state_dict_from_jax
