"""Driver-backed secrets: fetch secret values from external provider
plugins at assignment time instead of the store payload.

Reference: manager/drivers/provider.go (DriverProvider) and secrets.go
(SecretDriver.Get posting a SecretsProviderRequest to the plugin's
``/SecretProvider.GetSecret`` endpoint).  Plugins register as
name -> endpoint URL (the reference resolves docker plugin sockets; the
wire payload is identical) or name -> callable for in-process providers.
"""

from __future__ import annotations

import base64
import json
import logging
import urllib.error
import urllib.request
from typing import Callable, Dict, Optional, Tuple, Union

log = logging.getLogger("drivers")

SECRETS_PROVIDER_API = "/SecretProvider.GetSecret"


class SecretProviderError(Exception):
    """The plugin failed, rejected the request, or is not registered."""


Plugin = Union[str, Callable[[dict], dict]]


class SecretDriver:
    """reference: drivers/secrets.go:21 SecretDriver."""

    def __init__(self, plugin: Plugin):
        self._plugin = plugin

    def get(self, spec, task) -> Tuple[bytes, bool]:
        """Fetch the secret value for one task; returns
        (value, do_not_reuse) (reference: secrets.go:34 Get)."""
        if spec is None:
            raise SecretProviderError("secret spec is nil")
        if task is None:
            raise SecretProviderError("task is nil")
        container = task.spec.container
        req = {
            "SecretName": spec.annotations.name,
            "SecretLabels": dict(spec.annotations.labels),
            "ServiceID": task.service_id,
            "ServiceName": task.service_annotations.name,
            "ServiceLabels": dict(task.service_annotations.labels),
            "TaskID": task.id,
            "TaskName": f"{task.service_annotations.name}.{task.slot}"
                        f".{task.id}",
            "TaskImage": container.image if container else "",
            "ServiceHostname": container.hostname if container else "",
            "NodeID": task.node_id,
        }
        resp = self._call(req)
        if resp.get("Err"):
            raise SecretProviderError(resp["Err"])
        value = resp.get("Value")
        if value is None:
            raise SecretProviderError(
                "secret provider returned no value")
        if isinstance(value, str):
            value = base64.b64decode(value)
        return value, bool(resp.get("DoNotReuse", False))

    def _call(self, req: dict) -> dict:
        if callable(self._plugin):
            return self._plugin(req)
        url = self._plugin.rstrip("/") + SECRETS_PROVIDER_API
        data = json.dumps(req).encode()
        http_req = urllib.request.Request(
            url, data=data, headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(http_req, timeout=5) as resp:
                return json.loads(resp.read())
        except (urllib.error.URLError, OSError, ValueError) as e:
            raise SecretProviderError(
                f"secret provider {url} failed: {e}") from e


class DriverProvider:
    """reference: drivers/provider.go:11 — resolves a spec Driver to a
    SecretDriver backed by a registered provider plugin."""

    def __init__(self, plugins: Optional[Dict[str, Plugin]] = None):
        self._plugins = dict(plugins or {})

    def register(self, name: str, plugin: Plugin) -> None:
        self._plugins[name] = plugin

    def new_secret_driver(self, driver) -> SecretDriver:
        if driver is None or not driver.name:
            raise SecretProviderError("driver specification is nil")
        plugin = self._plugins.get(driver.name)
        if plugin is None:
            raise SecretProviderError(
                f"plugin {driver.name!r} not found")
        return SecretDriver(plugin)
