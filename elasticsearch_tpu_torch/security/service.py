"""Security v1: authentication (basic + API key) and role-based
authorization as a REST action filter.

Re-designs the reference's security plugin core (ref:
x-pack/plugin/security/src/main/java/org/elasticsearch/xpack/security/
authc/AuthenticationService.java:71 realm-chain authentication,
authz/AuthorizationService.java:100 privilege resolution,
authz/store/ReservedRolesStore.java built-in roles) at this framework's
scale: a native realm (PBKDF2-hashed users), API keys, and roles with
cluster privileges + index privilege grants matched by wildcard pattern.
Every REST call passes the filter before its handler — authc failure is
401, authz failure 403 — and anonymous access exists ONLY when the
operator grants the anonymous user roles (off by default when security is
enabled, the reference's xpack.security.authc.anonymous.* contract).

Index-privilege checks happen at the ROUTE's target expression; the
NDJSON bodies of _bulk/_msearch are scanned for their per-item target
indices so a role scoped to `logs-*` cannot smuggle writes to another
index through a global bulk (the REST-layer approximation of the
reference's per-item action-level checks).

The port's copy of elasticsearch_tpu/security/service.py.
"""

from __future__ import annotations

import base64
import fnmatch
import hashlib
import hmac
import json
import os
import secrets
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from elasticsearch_tpu_torch.common.errors import (
    ElasticsearchTpuError, IllegalArgumentError,
)


class AuthenticationError(ElasticsearchTpuError):
    status = 401
    error_type = "security_exception"


class AuthorizationError(ElasticsearchTpuError):
    status = 403
    error_type = "security_exception"


# ---- privileges ----

CLUSTER_PRIVS = {"all", "monitor", "manage", "manage_security"}
INDEX_PRIVS = {"all", "read", "write", "create_index", "delete_index",
               "manage"}
# implication lattice (ref: IndexPrivilege/ClusterPrivilege resolution)
_CLUSTER_IMPLIES = {"all": {"monitor", "manage", "manage_security"},
                    "manage": {"monitor"}}
_INDEX_IMPLIES = {"all": {"read", "write", "create_index", "delete_index",
                          "manage"},
                  "manage": {"create_index", "delete_index"}}


def _implied(granted: Sequence[str], implies: dict) -> set:
    out = set(granted)
    for g in granted:
        out |= implies.get(g, set())
    return out


@dataclass
class Role:
    name: str
    cluster: List[str] = field(default_factory=list)
    indices: List[dict] = field(default_factory=list)  # {names, privileges}

    def grants_cluster(self, priv: str) -> bool:
        return priv in _implied(self.cluster, _CLUSTER_IMPLIES)

    def grants_index(self, priv: str, index: str) -> bool:
        for grant in self.indices:
            if priv not in _implied(grant.get("privileges", ()),
                                    _INDEX_IMPLIES):
                continue
            for pat in grant.get("names", ()):
                if fnmatch.fnmatchcase(index, pat):
                    return True
        return False


SUPERUSER = Role("superuser", cluster=["all"],
                 indices=[{"names": ["*"], "privileges": ["all"]}])
_BUILTIN_ROLES = {
    "superuser": SUPERUSER,
    "monitoring_user": Role("monitoring_user", cluster=["monitor"]),
}


@dataclass
class User:
    username: str
    pw_hash: bytes
    salt: bytes
    roles: List[str] = field(default_factory=list)
    enabled: bool = True


@dataclass
class Authentication:
    username: str
    roles: List[Role]
    auth_type: str = "realm"        # realm | api_key | anonymous


def _hash_pw(password: str, salt: bytes) -> bytes:
    return hashlib.pbkdf2_hmac("sha256", password.encode("utf-8"), salt,
                               10_000)


class SecurityService:
    """Realms + role store + the REST action filter."""

    def __init__(self, settings=None):
        raw = (lambda k, d=None: settings.raw(k, d)) if settings is not None \
            else (lambda k, d=None: d)
        self.enabled = str(raw("xpack.security.enabled", "false")
                           ).lower() == "true"
        self._lock = threading.Lock()
        self.users: Dict[str, User] = {}
        self.roles: Dict[str, Role] = dict(_BUILTIN_ROLES)
        self.api_keys: Dict[str, dict] = {}   # id -> {hash, salt, user, ...}
        anon = raw("xpack.security.authc.anonymous.roles")
        self.anonymous_roles = ([r.strip() for r in str(anon).split(",")]
                                if anon else None)
        bootstrap = str(raw("bootstrap.password", "changeme"))
        self._put_user_locked("elastic", bootstrap, ["superuser"])

    # ---------------- user / role / key management ----------------

    def _put_user_locked(self, name: str, password: str,
                         roles: List[str]) -> None:
        salt = os.urandom(16)
        self.users[name] = User(name, _hash_pw(password, salt), salt,
                                list(roles))

    def put_user(self, name: str, password: Optional[str],
                 roles: List[str]) -> None:
        with self._lock:
            if password is None:
                cur = self.users.get(name)
                if cur is None:
                    raise IllegalArgumentError(
                        f"password is required to create user [{name}]")
                cur.roles = list(roles)
                return
            self._put_user_locked(name, password, roles)

    def delete_user(self, name: str) -> bool:
        with self._lock:
            return self.users.pop(name, None) is not None

    def put_role(self, name: str, body: dict) -> None:
        cluster = list(body.get("cluster", ()))
        bad = set(cluster) - CLUSTER_PRIVS
        if bad:
            raise IllegalArgumentError(
                f"unknown cluster privileges {sorted(bad)}")
        indices = []
        for grant in body.get("indices", ()):
            privs = list(grant.get("privileges", ()))
            bad = set(privs) - INDEX_PRIVS
            if bad:
                raise IllegalArgumentError(
                    f"unknown index privileges {sorted(bad)}")
            indices.append({"names": list(grant.get("names", ())),
                            "privileges": privs})
        with self._lock:
            self.roles[name] = Role(name, cluster=cluster, indices=indices)

    def delete_role(self, name: str) -> bool:
        with self._lock:
            if name in _BUILTIN_ROLES:
                raise IllegalArgumentError(
                    f"role [{name}] is reserved")
            return self.roles.pop(name, None) is not None

    def create_api_key(self, for_user: str, name: str,
                       roles: Optional[List[str]] = None,
                       owned_roles: Optional[List[str]] = None) -> dict:
        key_id = secrets.token_hex(10)
        secret = secrets.token_urlsafe(24)
        salt = os.urandom(16)
        with self._lock:
            owner_roles = list(self.users[for_user].roles) \
                if for_user in self.users else []
            self.api_keys[key_id] = {
                "name": name, "hash": _hash_pw(secret, salt), "salt": salt,
                "username": for_user,
                "roles": list(roles) if roles is not None else owner_roles,
                "owned_roles": list(owned_roles or ()),
                "invalidated": False,
            }
        encoded = base64.b64encode(
            f"{key_id}:{secret}".encode("ascii")).decode("ascii")
        return {"id": key_id, "name": name, "api_key": secret,
                "encoded": encoded}

    def invalidate_api_key(self, key_id: str) -> bool:
        with self._lock:
            k = self.api_keys.get(key_id)
            if k is None:
                return False
            k["invalidated"] = True
            for rname in k.get("owned_roles", ()):
                self.roles.pop(rname, None)   # key-owned ad-hoc roles die
            return True

    # ---------------- authentication ----------------

    def authenticate(self, headers: Dict[str, str]) -> Authentication:
        auth = headers.get("authorization")
        if auth:
            scheme, _, payload = auth.partition(" ")
            scheme = scheme.lower()
            if scheme == "basic":
                return self._authc_basic(payload.strip())
            if scheme == "apikey":
                return self._authc_api_key(payload.strip())
            raise AuthenticationError(
                f"unsupported authorization scheme [{scheme}]")
        if self.anonymous_roles is not None:
            return Authentication("_anonymous",
                                  self._resolve_roles(self.anonymous_roles),
                                  "anonymous")
        raise AuthenticationError(
            "missing authentication credentials for REST request")

    def _authc_basic(self, payload: str) -> Authentication:
        try:
            user, _, password = base64.b64decode(payload).decode(
                "utf-8").partition(":")
        except Exception:
            raise AuthenticationError("invalid basic authentication header")
        u = self.users.get(user)
        if (u is None or not u.enabled
                or not hmac.compare_digest(u.pw_hash,
                                           _hash_pw(password, u.salt))):
            raise AuthenticationError(
                f"unable to authenticate user [{user}]")
        return Authentication(user, self._resolve_roles(u.roles))

    def _authc_api_key(self, payload: str) -> Authentication:
        try:
            key_id, _, secret = base64.b64decode(payload).decode(
                "utf-8").partition(":")
        except Exception:
            raise AuthenticationError("invalid ApiKey header")
        k = self.api_keys.get(key_id)
        if (k is None or k["invalidated"]
                or not hmac.compare_digest(k["hash"],
                                           _hash_pw(secret, k["salt"]))):
            raise AuthenticationError("unable to authenticate api key")
        return Authentication(k["username"],
                              self._resolve_roles(k["roles"]), "api_key")

    def _resolve_roles(self, names: Sequence[str]) -> List[Role]:
        return [self.roles[n] for n in names if n in self.roles]

    # ---------------- authorization ----------------

    def authorize_cluster(self, authn: Authentication, priv: str) -> None:
        if any(r.grants_cluster(priv) for r in authn.roles):
            return
        raise AuthorizationError(
            f"action [cluster:{priv}] is unauthorized for user "
            f"[{authn.username}]")

    def authorize_index(self, authn: Authentication, priv: str,
                        indices: Sequence[str]) -> None:
        for index in indices:
            if not any(r.grants_index(priv, index) for r in authn.roles):
                raise AuthorizationError(
                    f"action [indices:{priv}] is unauthorized for user "
                    f"[{authn.username}] on indices [{index}]")

    # ---------------- the REST action filter ----------------

    def rest_filter(self, req, parts: List[str]) -> None:
        authn = self.authenticate(req.headers)
        req.params["_authn_user"] = authn.username
        kind, priv, indices = _classify(req, parts)
        if kind == "cluster":
            self.authorize_cluster(authn, priv)
        elif kind == "index":
            self.authorize_index(authn, priv, indices)
        elif kind == "multi":
            # compound actions (_reindex): every (privilege, indices)
            # check must pass
            for p, idxs in priv:
                self.authorize_index(authn, p, idxs)
        # kind == "open": _authenticate etc — authn only


_READ_ENDPOINTS = {"_search", "_msearch", "_count", "_mget", "_doc",
                   "_source", "_explain", "_termvectors", "_field_caps",
                   "_validate", "_search_shards", "_analyze", "_pit",
                   "_knn_search", "_rank_eval"}
_WRITE_ENDPOINTS = {"_bulk", "_update", "_update_by_query",
                    "_delete_by_query", "_create"}
# _reindex and _aliases are NOT here: both name data indices in their
# bodies and classify as index actions below (a cluster-manage role must
# not read arbitrary indices through reindex, nor repoint aliases on
# indices it cannot manage). _scripts stays cluster-scoped on purpose —
# stored scripts are cluster metadata (ref: cluster:admin/script/put);
# data access only happens when a script runs inside a search, which is
# authorized as that search.
_CLUSTER_PREFIXES = {"_cluster", "_nodes", "_cat", "_tasks", "_snapshot",
                     "_scripts", "_ingest", "_template", "_index_template",
                     "_component_template", "_alias", "_stats",
                     "_async_search", "_render", "_scroll",
                     "_search_scroll", "_mapping", "_resolve"}


def _ndjson_indices(raw: bytes, default: Optional[str],
                    meta_key: str) -> List[str]:
    out = set()
    if default:
        out.add(default)
    lines = [ln for ln in raw.split(b"\n") if ln.strip()]
    if meta_key == "bulk":
        for line in lines:
            try:
                obj = json.loads(line)
            except Exception:
                continue
            if isinstance(obj, dict):
                for action in ("index", "create", "update", "delete"):
                    spec = obj.get(action)
                    if isinstance(spec, dict) and spec.get("_index"):
                        out.add(str(spec["_index"]))
    else:
        # msearch: even lines are HEADERS; one without an explicit index
        # targets the path default or, absent that, every index — it must
        # demand "*" so a scoped role cannot widen through an empty header
        for i in range(0, len(lines), 2):
            try:
                obj = json.loads(lines[i])
            except Exception:
                continue
            if not isinstance(obj, dict):
                continue
            v = obj.get("index")
            if v:
                out.update(v if isinstance(v, list) else [v])
            elif default is None:
                out.add("*")
    return sorted(out)


def _classify(req, parts: List[str]):
    """(kind, privilege, indices) for a REST call — the route->privilege
    map (ref: the reference's action-name driven authorization; REST paths
    map 1:1 onto action families here)."""
    if not parts:
        return "cluster", "monitor", None
    head = parts[0]
    if head == "_security":
        if parts[1:2] == ["_authenticate"]:
            return "open", None, None
        return "cluster", "manage_security", None
    if head == "_bulk":
        return "index", "write", _ndjson_indices(req.raw_body, None, "bulk")
    if head == "_msearch":
        return "index", "read", _ndjson_indices(req.raw_body, None, "ms") \
            or ["*"]
    if head == "_mget":
        body = req.body if isinstance(req.body, dict) else {}
        targets = {str(d["_index"]) for d in (body.get("docs") or [])
                   if isinstance(d, dict) and d.get("_index")}
        return "index", "read", sorted(targets) or ["*"]
    if head == "_reindex":
        # an INDEX action on both ends — read the source, write the dest
        # (ref: TransportReindexAction resolves per-index privileges); a
        # body that names no index demands the privilege on "*" so a
        # scoped role cannot widen through a malformed request
        body = req.body if isinstance(req.body, dict) else {}
        src = (body.get("source") or {}).get("index") \
            if isinstance(body.get("source"), dict) else None
        dst = (body.get("dest") or {}).get("index") \
            if isinstance(body.get("dest"), dict) else None
        src_list = sorted({str(s) for s in
                           (src if isinstance(src, list) else [src]) if s}) \
            or ["*"]
        dst_list = [str(dst)] if dst else ["*"]
        return "multi", [("read", src_list), ("write", dst_list)], None
    if head == "_aliases":
        # alias actions name their indices in the body: index `manage` on
        # each target (ref: TransportIndicesAliasesAction)
        body = req.body if isinstance(req.body, dict) else {}
        targets = set()
        for action in (body.get("actions") or []):
            if not isinstance(action, dict):
                continue
            for spec in action.values():
                if not isinstance(spec, dict):
                    continue
                v = spec.get("index") or spec.get("indices")
                if v:
                    targets.update(str(i) for i in
                                   (v if isinstance(v, list) else [v]))
        return "index", "manage", sorted(targets) or ["*"]
    if head.startswith("_") and head != "_all":
        if head in _CLUSTER_PREFIXES or head not in _READ_ENDPOINTS:
            return ("cluster",
                    "monitor" if req.method in ("GET", "HEAD") else "manage",
                    None)
        return "index", "read", ["*"]

    # "_all" is an index expression, not a cluster endpoint: it demands
    # the privilege on "*"
    indices = ["*"] if head == "_all" else \
        [n.strip() for n in head.split(",") if n.strip()]
    sub = parts[1] if len(parts) > 1 else None
    if sub is None:
        if req.method in ("GET", "HEAD"):
            return "index", "read", indices
        if req.method == "PUT":
            return "index", "create_index", indices
        if req.method == "DELETE":
            return "index", "delete_index", indices
        return "index", "manage", indices
    if sub == "_bulk":
        return "index", "write", _ndjson_indices(req.raw_body, head, "bulk")
    if sub in ("_msearch",):
        return "index", "read", _ndjson_indices(req.raw_body, head, "ms")
    if sub == "_mget":
        # per-doc "_index" overrides join the authorized set (the handler
        # honors them)
        extra = set(indices)
        body = req.body if isinstance(req.body, dict) else {}
        for d in (body.get("docs") or []):
            if isinstance(d, dict) and d.get("_index"):
                extra.add(str(d["_index"]))
        return "index", "read", sorted(extra)
    if sub in ("_doc", "_create", "_update"):
        return ("index",
                "read" if req.method in ("GET", "HEAD") else "write",
                indices)
    if sub in _READ_ENDPOINTS:
        return "index", "read", indices
    if sub in _WRITE_ENDPOINTS or sub == "_delete_by_query":
        return "index", "write", indices
    if sub in ("_rollover", "_shrink", "_split", "_clone"):
        return "index", "manage", indices
    # _settings/_mapping/_close/_open/_refresh/_flush/_forcemerge/_cache...
    return ("index",
            "read" if req.method in ("GET", "HEAD") else "manage",
            indices)
