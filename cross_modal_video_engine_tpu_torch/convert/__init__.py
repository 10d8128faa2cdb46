from .from_jax import (clip_state_dict_from_jax,
                       recognizer_state_dict_from_jax,
                       timesformer_state_dict_from_jax)
