"""Tyro-style dotted CLI flags over the model-config dataclasses.

Counterpart of ``uncertainty_nerf_gs_tpu/configs/flags.py``, with the same
coercions and the same errors: unknown ``--model.<field>`` (or the
reference's ``--pipeline.model.<field>``) flags are resolved against the
method's model-config dataclass, kebab-case mapping to snake_case, with
values coerced to the field's declared type. The parsed overrides land in
the run's ``config.json``/``config.yml`` like ``--overrides`` JSON does.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any

# flag prefixes accepted for model-config fields; the long form mirrors the
# reference's `--pipeline.model.` surface verbatim
_PREFIXES = ("--model.", "--pipeline.model.")


def _coerce(raw: str, annot: Any, current: Any) -> Any:
    """Coerce a CLI string to the dataclass field's type."""
    base = type(current) if current is not None else annot
    if base is bool or annot is bool:
        low = raw.lower()
        if low in ("true", "1", "on", "yes"):
            return True
        if low in ("false", "0", "off", "no"):
            return False
        raise ValueError(f"expected a boolean, got {raw!r}")
    if base is int or annot is int:
        return int(raw)
    if base is float or annot is float:
        return float(raw)
    if base is str or annot is str:
        return raw
    # tuples / dicts / None-defaulted fields: accept JSON, falling back to
    # the raw string (e.g. aabb, proposal_net_args)
    try:
        val = json.loads(raw)
    except json.JSONDecodeError:
        return raw
    if isinstance(val, list) and isinstance(current, tuple):
        return tuple(val)
    return val


def parse_dotted_flags(
    extra: list[str], model_config: Any
) -> tuple[dict[str, Any], dict[str, str]]:
    """Parse leftover argv into (model_overrides, special).

    ``extra``: unconsumed args from ``parse_known_args`` — must all be
    dotted flags (``--model.beta-min 0.02`` or ``--model.beta-min=0.02``).
    ``model_config``: the method's model-config dataclass instance; fields
    are matched kebab->snake and values coerced to the field type.

    ``special`` currently holds ``camera_opt`` ("on"/"off") when the
    reference's ``--model.camera-optimizer.mode`` spelling is used — the
    camera optimizer is an engine concern here, not a model-config field
    (`engine/trainer.py`), matching `laplace_config.py:37`'s
    SO3xR3-or-off surface.
    """
    fields = {f.name: f for f in dataclasses.fields(model_config)}
    overrides: dict[str, Any] = {}
    special: dict[str, str] = {}

    i = 0
    while i < len(extra):
        arg = extra[i]
        prefix = next((p for p in _PREFIXES if arg.startswith(p)), None)
        if prefix is None:
            raise SystemExit(
                f"unrecognized argument: {arg} (model-config flags are "
                f"--model.<field>; see --help)"
            )
        body = arg[len(prefix):]
        if "=" in body:
            dotted, raw = body.split("=", 1)
            i += 1
        else:
            dotted = body
            if i + 1 >= len(extra):
                raise SystemExit(f"flag {arg} expects a value")
            raw = extra[i + 1]
            i += 2

        if dotted in ("camera-optimizer.mode", "camera_optimizer.mode"):
            # `--pipeline.model.camera-optimizer.mode off` (README:122)
            special["camera_opt"] = "off" if raw == "off" else "on"
            continue
        name = dotted.replace("-", "_").replace(".", "_")
        if name not in fields:
            known = ", ".join(sorted(fields))
            raise SystemExit(
                f"unknown model-config field {dotted!r} for "
                f"{type(model_config).__name__} (known: {known})"
            )
        f = fields[name]
        try:
            overrides[name] = _coerce(raw, f.type, getattr(model_config, name))
        except (ValueError, TypeError) as e:
            raise SystemExit(f"bad value for --model.{dotted}: {e}")
    return overrides, special
