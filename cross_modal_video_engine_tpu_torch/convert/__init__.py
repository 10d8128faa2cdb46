from .from_jax import clip_state_dict_from_jax
