"""Capability allow/deny matrices (reference: core/src/dbs/capabilities.rs
+ the server's SURREAL_CAPS_* environment flags, server/src/dbs/mod.rs).

A Capabilities value hangs off the Datastore and is consulted at the
dispatch sites: function calls (family prefixes like `http` match whole
families), embedded scripting, network targets for http::*, guest access
on the network surface, and RPC methods. Deny always wins over allow.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field


def _split(v: str) -> set:
    return {x.strip() for x in v.split(",") if x.strip()}


@dataclass
class Targets:
    """All / None / a named subset (function families, hosts, methods)."""

    all: bool = False
    names: set = field(default_factory=set)

    @classmethod
    def parse(cls, v):
        if v is None:
            return None
        if isinstance(v, bool):
            return cls(all=v)
        s = str(v).strip()
        if s.lower() in ("", "none", "false"):
            return cls(all=False)
        if s.lower() in ("*", "all", "true"):
            return cls(all=True)
        return cls(all=False, names=_split(s))

    def matches(self, name: str) -> bool:
        if self.all:
            return True
        name = name.lower()
        for n in self.names:
            n = n.lower()
            if name == n:
                return True
            # family prefix: "http" covers http::get, "crypto::argon2"
            # covers crypto::argon2::compare
            if name.startswith(n + "::"):
                return True
            # host:port targets: "example.com" covers any port
            if ":" in name and name.split(":", 1)[0] == n:
                return True
        return False


class Capabilities:
    def __init__(self, *, scripting=True, guest_access=False,
                 live_queries=True, allow_funcs=None, deny_funcs=None,
                 allow_net=None, deny_net=None, allow_rpc=None,
                 deny_rpc=None, allow_experimental=None,
                 arbitrary_query=True):
        self.scripting = scripting
        self.guest_access = guest_access
        self.live_queries = live_queries
        self.allow_funcs = allow_funcs if allow_funcs is not None else \
            Targets(all=True)
        self.deny_funcs = deny_funcs if deny_funcs is not None else Targets()
        # network access is deny-by-default (reference server default)
        self.allow_net = allow_net if allow_net is not None else Targets()
        self.deny_net = deny_net if deny_net is not None else Targets()
        self.allow_rpc = allow_rpc if allow_rpc is not None else \
            Targets(all=True)
        self.deny_rpc = deny_rpc if deny_rpc is not None else Targets()
        self.allow_experimental = allow_experimental \
            if allow_experimental is not None else Targets()
        self.arbitrary_query = arbitrary_query

    # -- construction --------------------------------------------------------
    @classmethod
    def from_env(cls, env=None) -> "Capabilities":
        """SURREAL_CAPS_* environment flags (server/src/dbs/mod.rs)."""
        e = os.environ if env is None else env

        def flag(name, default):
            v = e.get(name)
            if v is None:
                return default
            return str(v).lower() not in ("", "0", "false", "none")

        caps = cls(
            scripting=flag("SURREAL_CAPS_ALLOW_SCRIPT", True),
            guest_access=flag("SURREAL_CAPS_ALLOW_GUESTS", False),
        )
        if flag("SURREAL_CAPS_ALLOW_ALL", False):
            caps.allow_net = Targets(all=True)
            caps.guest_access = True
        if flag("SURREAL_CAPS_DENY_ALL", False):
            caps.allow_funcs = Targets()
            caps.scripting = False
            caps.guest_access = False
        for name, attr in (
            ("SURREAL_CAPS_ALLOW_FUNC", "allow_funcs"),
            ("SURREAL_CAPS_DENY_FUNC", "deny_funcs"),
            ("SURREAL_CAPS_ALLOW_NET", "allow_net"),
            ("SURREAL_CAPS_DENY_NET", "deny_net"),
            ("SURREAL_CAPS_ALLOW_RPC", "allow_rpc"),
            ("SURREAL_CAPS_DENY_RPC", "deny_rpc"),
            ("SURREAL_CAPS_ALLOW_EXPERIMENTAL", "allow_experimental"),
        ):
            v = e.get(name)
            if v is not None:
                setattr(caps, attr, Targets.parse(v))
        return caps

    # -- checks --------------------------------------------------------------
    def allows_function(self, name: str) -> bool:
        if self.deny_funcs.matches(name):
            return False
        return self.allow_funcs.matches(name)

    def allows_net(self, target: str) -> bool:
        if self.deny_net.matches(target):
            return False
        return self.allow_net.matches(target)

    def allows_rpc(self, method: str) -> bool:
        if self.deny_rpc.matches(method):
            return False
        return self.allow_rpc.matches(method)

    def allows_experimental(self, feature: str) -> bool:
        return self.allow_experimental.matches(feature)
