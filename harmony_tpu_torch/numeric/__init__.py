from .dec import Dec, new_dec, one_dec, zero_dec  # noqa: F401
