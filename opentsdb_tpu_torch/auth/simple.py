"""Authentication and authorization (ref: ``src/auth/``; the JAX
package's ``auth/simple.py``).

The ABI of ``Authentication.java:36``, ``AuthState`` and
``Permissions.java:25``: an authenticator asked at the first exchange
of a connection (the telnet ``auth`` command, or HTTP Basic on every
request), and a permission set that gates each RPC. With
``tsd.core.authentication.enable`` the TSDB builds
:class:`SimpleAuthentication`, which lets everyone in, as the
reference's ``AllowAllAuthenticatingAuthorizer``, until users are
configured.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import secrets
from enum import Enum, auto


class Permissions(Enum):
    """The full reference permission set
    (ref: src/auth/Permissions.java:25-27)."""
    TELNET_PUT = auto()
    HTTP_PUT = auto()
    HTTP_QUERY = auto()
    CREATE_TAGK = auto()
    CREATE_TAGV = auto()
    CREATE_METRIC = auto()


ALL_PERMISSIONS = frozenset(Permissions)


class AuthStatus(Enum):
    SUCCESS = auto()
    UNAUTHORIZED = auto()
    FORBIDDEN = auto()
    REDIRECTED = auto()
    ERROR = auto()


class AuthState:
    """(ref: src/auth/AuthState.java)"""

    def __init__(self, user: str, status: AuthStatus,
                 message: str = "", roles: set[str] | None = None,
                 permissions: frozenset | None = None):
        self.user = user
        self.status = status
        self.message = message
        self.roles = roles or set()
        # None = no role config: every authenticated user gets
        # everything (as AllowAllAuthenticatingAuthorizer)
        self.permissions = (ALL_PERMISSIONS if permissions is None
                            else permissions)
        self.token: bytes | None = None

    def has_permission(self, perm: Permissions) -> bool:
        """(ref: Permissions.java gating HTTP_QUERY/HTTP_PUT/
        TELNET_PUT/CREATE_* per role)"""
        return self.status == AuthStatus.SUCCESS and \
            perm in self.permissions


class SimpleAuthentication:
    """Username/password authenticator with role-based authorization.

    - ``tsd.core.authentication.users`` =
      ``user1:sha256hex[:role1|role2],user2:sha256hex`` — with no
      users configured every auth attempt succeeds
      (as AllowAllAuthenticatingAuthorizer).
    - ``tsd.core.authentication.roles`` =
      ``reader:http_query,writer:http_put|telnet_put,admin:all`` —
      maps role names to granted :class:`Permissions`; with no roles
      configured every authenticated user holds every permission.
      A user with no roles (while roles ARE configured) holds none.
    """

    def __init__(self, config):
        self._users: dict[str, tuple[str, set[str]]] = {}
        spec = config.get_string("tsd.core.authentication.users", "")
        for entry in filter(None, (e.strip() for e in spec.split(","))):
            parts = entry.split(":")
            user = parts[0]
            digest = parts[1].lower() if len(parts) > 1 else ""
            roles = set(filter(None, parts[2].split("|"))) \
                if len(parts) > 2 else set()
            self._users[user] = (digest, roles)
        self._role_grants: dict[str, frozenset] = {}
        rspec = config.get_string("tsd.core.authentication.roles", "")
        for entry in filter(None, (e.strip()
                                   for e in rspec.split(","))):
            role, _, perms = entry.partition(":")
            granted = set()
            for p in filter(None, perms.split("|")):
                if p.strip().lower() in ("all", "*"):
                    granted |= ALL_PERMISSIONS
                else:
                    try:
                        granted.add(Permissions[p.strip().upper()])
                    except KeyError:
                        valid = ", ".join(
                            x.name.lower() for x in Permissions)
                        raise ValueError(
                            "invalid permission "
                            f"{p.strip()!r} in tsd.core."
                            f"authentication.roles entry "
                            f"{entry!r} (valid: {valid}, 'all')"
                        ) from None
            self._role_grants[role.strip()] = frozenset(granted)

    def _permissions_for(self, roles: set[str]) -> frozenset | None:
        if not self._role_grants:
            return None  # no role config: everything
        granted: set = set()
        for r in roles:
            granted |= self._role_grants.get(r, frozenset())
        return frozenset(granted)

    def authenticate(self, user: str, password: str) -> AuthState:
        if not self._users:
            return AuthState(user or "anonymous", AuthStatus.SUCCESS)
        digest = hashlib.sha256(password.encode()).hexdigest()
        entry = self._users.get(user)
        if entry is not None and hmac.compare_digest(digest, entry[0]):
            state = AuthState(user, AuthStatus.SUCCESS,
                              roles=set(entry[1]),
                              permissions=self._permissions_for(
                                  entry[1]))
            state.token = secrets.token_bytes(16)
            return state
        return AuthState(user, AuthStatus.UNAUTHORIZED,
                         "invalid credentials")

    def authenticate_telnet(self, command: list[str]) -> AuthState:
        """telnet: ``auth <user> <password>``
        (ref: AuthenticationChannelHandler.java:50)."""
        if len(command) < 3:
            return AuthState("", AuthStatus.ERROR,
                             "format: auth <user> <password>")
        return self.authenticate(command[1], command[2])

    def authenticate_http(self, headers: dict[str, str]) -> AuthState:
        """HTTP: Basic authorization header
        (ref: AuthenticationChannelHandler HTTP branch)."""
        if not self._users:
            # AllowAllAuthenticatingAuthorizer: everything passes,
            # whatever the headers
            return AuthState("anonymous", AuthStatus.SUCCESS)
        raw = headers.get("authorization", "")
        if not raw:
            return AuthState("", AuthStatus.UNAUTHORIZED,
                             "missing Authorization header")
        scheme, _, payload = raw.partition(" ")
        if scheme.lower() != "basic":
            return AuthState("", AuthStatus.UNAUTHORIZED,
                             f"unsupported auth scheme {scheme!r}")
        try:
            user, _, password = base64.b64decode(payload.strip()) \
                .decode("utf-8").partition(":")
        except Exception:  # noqa: BLE001 - any bad payload is an ERROR
            return AuthState("", AuthStatus.ERROR,
                             "malformed Basic credentials")
        return self.authenticate(user, password)
