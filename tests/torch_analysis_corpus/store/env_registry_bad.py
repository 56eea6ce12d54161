"""Seeded ENV-REGISTRY violations against the port's registry (never
imported)."""
import os

from constdb_tpu_torch.conf import env_int


def direct_read():
    return os.environ.get("CONSTDB_TORCH_SECRET_KNOB", "1")   # ENV-REGISTRY


def subscript_read():
    return os.environ["CONSTDB_TORCH_OTHER_KNOB"]             # ENV-REGISTRY


def unregistered_helper_read():
    return env_int("CONSTDB_TORCH_NOT_IN_REGISTRY", 3)        # ENV-REGISTRY


def reference_knob_read():
    return env_int("CONSTDB_POOL_FLUSH_MB", 1536)   # ENV-REGISTRY: the
    #                                                 reference's knob


def fine():
    return env_int("CONSTDB_TORCH_POOL_FLUSH_MB", 1536)   # clean: registered
