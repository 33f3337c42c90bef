"""Model zoo of the port (counterpart of ``veles_tpu/models``).

Each module exposes ``create_workflow(launcher)`` and reads its
parameters from the global config tree under ``root.<model>``
(defaults merged in, config files win).
"""

from veles_tpu_torch.config import root


def model_config(name: str, defaults: dict):
    """Merge defaults under root.<name> without clobbering overrides."""
    node = getattr(root, name)
    node.update(dict_merge(defaults, node.todict()))
    return node


def dict_merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = dict_merge(out[k], v)
        else:
            out[k] = v
    return out
