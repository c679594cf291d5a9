"""Template expansion of container specs and secret/config payloads.

Reference: template/{context.go,expand.go,getter.go}.

The reference uses Go text/template with a strict context; here the same
strict context drives a small ``{{ ... }}`` expander supporting:

* dotted lookups: ``{{.Service.ID}}``, ``{{.Service.Name}}``,
  ``{{.Service.Labels}}`` (or a specific label via ``index``),
  ``{{.Node.ID}}``, ``{{.Node.Hostname}}``, ``{{.Node.Platform.OS}}``,
  ``{{.Node.Platform.Architecture}}``, ``{{.Task.ID}}``,
  ``{{.Task.Name}}``, ``{{.Task.Slot}}``;
* ``{{index .Service.Labels "key"}}``;
* payload-context functions (secret/config payloads only):
  ``{{secret "name"}}``, ``{{config "name"}}``, ``{{env "VAR"}}``.

Unknown expressions raise ``TemplateError`` — the reference fails task
preparation the same way.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional

from .models.objects import Task
from .models.types import NodeDescription

_EXPR = re.compile(r"\{\{\s*(.*?)\s*\}\}")
_INDEX = re.compile(r'^index\s+(\.[A-Za-z.]+)\s+"([^"]*)"$')
_FUNC = re.compile(r'^(secret|config|env)\s+"([^"]*)"$')


class TemplateError(Exception):
    pass


def task_name(t: Task) -> str:
    """reference: api/naming — <service>.<slot>.<task id> or
    <service>.<node>.<task id>."""
    base = t.service_annotations.name or t.service_id
    mid = str(t.slot) if t.slot else t.node_id
    return f"{base}.{mid}.{t.id}" if mid else f"{base}.{t.id}"


class Context:
    """Strict template context (reference: context.go:28)."""

    def __init__(self, node: Optional[NodeDescription], t: Task):
        platform = node.platform if node is not None else None
        self._values = {
            ".Service.ID": t.service_id,
            ".Service.Name": t.service_annotations.name,
            ".Node.ID": t.node_id,
            ".Node.Hostname": node.hostname if node is not None else "",
            ".Node.Platform.OS": platform.os if platform else "",
            ".Node.Platform.Architecture":
                platform.architecture if platform else "",
            ".Task.ID": t.id,
            ".Task.Name": task_name(t),
            ".Task.Slot": str(t.slot) if t.slot else t.node_id,
        }
        self._maps = {
            ".Service.Labels": dict(t.service_annotations.labels),
        }

    def _eval(self, expr: str, funcs) -> str:
        expr = expr.strip()
        if expr in self._values:
            return self._values[expr]
        m = _INDEX.match(expr)
        if m:
            mapping = self._maps.get(m.group(1))
            if mapping is None:
                raise TemplateError(f"unknown map {m.group(1)!r}")
            return mapping.get(m.group(2), "")
        m = _FUNC.match(expr)
        if m:
            fn = funcs.get(m.group(1)) if funcs else None
            if fn is None:
                raise TemplateError(
                    f"function {m.group(1)!r} not available in this "
                    "context")
            return fn(m.group(2))
        raise TemplateError(f"cannot evaluate template expression "
                            f"{expr!r}")

    def expand(self, text: str, funcs=None) -> str:
        def repl(m):
            return self._eval(m.group(1), funcs)

        return _EXPR.sub(repl, text)


def expand_container_spec(node: Optional[NodeDescription], t: Task):
    """Return a copy of the task's ContainerSpec with env, hostname, mount
    sources/targets, and labels expanded (reference: expand.go:18)."""
    spec = t.spec.container
    if spec is None:
        return None
    ctx = Context(node, t)
    out = spec.copy()
    out.env = [ctx.expand(e) for e in spec.env]
    out.hostname = ctx.expand(spec.hostname)
    out.labels = {k: ctx.expand(v) for k, v in spec.labels.items()}
    for m in out.mounts:
        m.source = ctx.expand(m.source)
        m.target = ctx.expand(m.target)
    return out


def expand_secret_payload(data: bytes, node: Optional[NodeDescription],
                          t: Task, secrets: Optional[Dict[str, bytes]] = None,
                          configs: Optional[Dict[str, bytes]] = None,
                          env: Optional[Dict[str, str]] = None) -> bytes:
    """Expand a templated secret/config payload with the payload-context
    functions (reference: expand.go:122 expandPayload)."""
    ctx = Context(node, t)
    # the env function sees the container's *expanded* environment
    expanded_env: Dict[str, str] = {}
    c = t.spec.container
    if c is not None:
        for e in c.env:
            k, _, v = e.partition("=")
            try:
                expanded_env[k] = ctx.expand(v)
            except TemplateError:
                expanded_env[k] = v
    if env:
        expanded_env.update(env)

    def env_fn(var: str) -> str:
        if var not in expanded_env:
            raise TemplateError(f"environment variable not present: {var}")
        return expanded_env[var]

    funcs = {
        "secret": lambda name: _lookup(secrets, name, "secret").decode(),
        "config": lambda name: _lookup(configs, name, "config").decode(),
        "env": env_fn,
    }
    try:
        text = data.decode("utf-8")
    except UnicodeDecodeError:
        return data  # binary payloads pass through
    return ctx.expand(text, funcs).encode("utf-8")


def _lookup(mapping, name, what):
    if mapping is None or name not in mapping:
        raise TemplateError(f"{what} not found: {name}")
    return mapping[name]
