from .from_jax import (clip_state_dict_from_jax,
                       dual_encoding_state_dict_from_jax,
                       dual_encoding_variables_to_jax,
                       linas_mask_state_from_jax, linas_mask_state_to_jax,
                       linas_train_state_from_jax, linas_train_state_to_jax,
                       recognizer_state_dict_from_jax,
                       reference_state_dicts,
                       timesformer_state_dict_from_jax)
