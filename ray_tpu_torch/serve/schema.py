"""Declarative config-file deploys, the port's copy of
``ray_tpu/serve/schema.py`` (reference: `serve/schema.py:519,735`
pydantic schemas + `serve deploy` in `serve/scripts.py`).

A config is a dict (usually loaded from YAML)::

    applications:
      - name: default
        import_path: my_module:app       # module path to a bound Application
        route_prefix: /api
        args: {...}                      # optional builder kwargs
        deployments:                     # optional per-deployment overrides
          - name: Model
            num_replicas: 4
            max_ongoing_requests: 16
            autoscaling_config: {min_replicas: 1, max_replicas: 8}

``import_path`` targets either a bound ``Application`` or a callable
``(**args) -> Application`` (the reference's app-builder pattern).
Validation is plain-dataclass (no pydantic in this environment) but
rejects the same classes of errors: unknown fields, missing import_path,
duplicate app names / route prefixes, malformed overrides. A
deployment's share of the card is ``num_gpus`` (the reference's
``num_tpus``, which is an unknown field here). ``yaml`` is imported only
by ``deploy_config_file``.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Dict, List, Optional

_DEPLOYMENT_OVERRIDE_FIELDS = {
    "name", "num_replicas", "num_cpus", "num_gpus", "max_ongoing_requests",
    "autoscaling_config", "route_prefix",
}
_APP_FIELDS = {"name", "import_path", "route_prefix", "args", "deployments"}


class SchemaError(ValueError):
    pass


@dataclasses.dataclass
class DeploymentOverride:
    name: str
    overrides: Dict[str, Any]

    @classmethod
    def parse(cls, raw: Dict[str, Any], app: str) -> "DeploymentOverride":
        if not isinstance(raw, dict) or "name" not in raw:
            raise SchemaError(
                f"app {app!r}: each deployments entry needs a 'name'")
        unknown = set(raw) - _DEPLOYMENT_OVERRIDE_FIELDS
        if unknown:
            raise SchemaError(
                f"app {app!r} deployment {raw['name']!r}: unknown "
                f"field(s) {sorted(unknown)}")
        ov = {k: v for k, v in raw.items() if k != "name"}
        if "num_replicas" in ov and ov["num_replicas"] != "auto" and (
                not isinstance(ov["num_replicas"], int)
                or ov["num_replicas"] < 0):
            raise SchemaError(
                f"app {app!r} deployment {raw['name']!r}: num_replicas "
                f"must be a non-negative int or 'auto'")
        if "autoscaling_config" in ov:
            if not isinstance(ov["autoscaling_config"], dict):
                raise SchemaError(
                    f"app {app!r} deployment {raw['name']!r}: "
                    f"autoscaling_config must be a mapping")
            from ray_tpu_torch.serve._private.autoscale import (
                validate_autoscaling_config)

            # Reject impossible bounds HERE, with the app/deployment in
            # the message — not at reconcile time deep in the controller.
            try:
                validate_autoscaling_config(ov["autoscaling_config"],
                                            error_cls=SchemaError)
            except SchemaError as e:
                raise SchemaError(
                    f"app {app!r} deployment {raw['name']!r}: {e}") \
                    from None
        return cls(name=raw["name"], overrides=ov)


@dataclasses.dataclass
class ApplicationSchema:
    name: str
    import_path: str
    route_prefix: Optional[str] = None
    args: Dict[str, Any] = dataclasses.field(default_factory=dict)
    deployments: List[DeploymentOverride] = dataclasses.field(
        default_factory=list)

    @classmethod
    def parse(cls, raw: Dict[str, Any], index: int) -> "ApplicationSchema":
        if not isinstance(raw, dict):
            raise SchemaError(f"applications[{index}] must be a mapping")
        name = raw.get("name", "default" if index == 0 else None)
        if not name:
            raise SchemaError(f"applications[{index}]: 'name' is required")
        unknown = set(raw) - _APP_FIELDS
        if unknown:
            raise SchemaError(
                f"app {name!r}: unknown field(s) {sorted(unknown)}")
        if not raw.get("import_path") or ":" not in raw["import_path"]:
            raise SchemaError(
                f"app {name!r}: 'import_path' must look like "
                f"'module.sub:attr'")
        args = raw.get("args") or {}
        if not isinstance(args, dict):
            raise SchemaError(f"app {name!r}: 'args' must be a mapping")
        return cls(
            name=name, import_path=raw["import_path"],
            route_prefix=raw.get("route_prefix"), args=args,
            deployments=[DeploymentOverride.parse(d, name)
                         for d in raw.get("deployments", [])])


@dataclasses.dataclass
class DeploySchema:
    applications: List[ApplicationSchema]

    @classmethod
    def parse(cls, raw: Dict[str, Any]) -> "DeploySchema":
        if not isinstance(raw, dict) or "applications" not in raw:
            raise SchemaError("config must be a mapping with 'applications'")
        apps = [ApplicationSchema.parse(a, i)
                for i, a in enumerate(raw["applications"])]
        names = [a.name for a in apps]
        if len(set(names)) != len(names):
            raise SchemaError(f"duplicate application names in {names}")
        prefixes = [a.route_prefix for a in apps if a.route_prefix]
        if len(set(prefixes)) != len(prefixes):
            raise SchemaError(f"duplicate route_prefix in {prefixes}")
        return cls(applications=apps)


# ------------------------------------------------------------------ deploy

def import_application(import_path: str, args: Optional[Dict] = None):
    """'module.sub:attr' -> bound Application (calling attr(**args) if it
    is an app-builder callable rather than a pre-bound Application)."""
    from ray_tpu_torch.serve.api import Application

    mod_name, _, attr = import_path.partition(":")
    target = importlib.import_module(mod_name)
    for part in attr.split("."):
        target = getattr(target, part)
    if isinstance(target, Application):
        if args:
            raise SchemaError(
                f"{import_path} is a bound Application; 'args' only apply "
                f"to app-builder functions")
        return target
    app = target(**(args or {}))
    if not isinstance(app, Application):
        raise SchemaError(
            f"{import_path} returned {type(app).__name__}, expected a "
            f"bound Application")
    return app


def deploy_config(config: Dict[str, Any]) -> List[str]:
    """Validate + deploy every application in the config. Returns the
    deployed app names. Apps present in a previous deploy but absent from
    this config are left running (reference `serve deploy` replaces the
    full target state; use serve.delete for removal — kept explicit
    here)."""
    from ray_tpu_torch.serve import api

    schema = DeploySchema.parse(config)
    deployed = []
    for app in schema.applications:
        bound = import_application(app.import_path, app.args)
        overrides = {d.name: d.overrides for d in app.deployments}
        api.run(bound, name=app.name, route_prefix=app.route_prefix,
                _overrides=overrides)
        deployed.append(app.name)
    return deployed


def deploy_config_file(path: str) -> List[str]:
    import yaml

    with open(path) as f:
        return deploy_config(yaml.safe_load(f))
