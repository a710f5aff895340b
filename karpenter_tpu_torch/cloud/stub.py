"""Local stub cloud REST server: the wire-level test double
(port of ``karpenter_tpu/cloud/stub.py``).

Serves the exact protocol :class:`~karpenter_tpu_torch.cloud.vpc.VPCCloudClient`
and :class:`~karpenter_tpu_torch.cloud.iks.IKSClient` speak, delegating every
operation to a backing :class:`FakeCloud` / :class:`FakeIKS` — so the
HTTP clients are contract-tested against the same semantics (quota,
capacity limits, zone validation, atomic pool resize, injected errors)
the in-memory fakes enforce, without a real cloud account (the reference
tests its client layer the same way: in-memory API doubles behind the SDK
interface, ``pkg/fake/vpcapi.go:32``).

Auth: ``POST /identity/token`` exchanges the configured api key for a
bearer token; every other route requires it.  401s from bad/expired
tokens exercise the client's invalidate-and-refresh path.

Error mapping: :class:`CloudError` -> HTTP status + IBM-style envelope
``{"errors": [{"message", "code"}]}``; rate-limit errors carry
``Retry-After`` so the 429 retry contract is testable end-to-end.
"""

from __future__ import annotations

import json
import secrets
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from karpenter_tpu_torch.cloud.errors import CloudError
from karpenter_tpu_torch.cloud.fake import FakeCloud
from karpenter_tpu_torch.cloud.fake_iks import FakeIKS
from karpenter_tpu_torch.cloud.resources import Volume
from karpenter_tpu_torch.cloud.iks import pool_to_json, worker_to_json
from karpenter_tpu_torch.cloud.vpc import (
    image_to_json, instance_to_json, profile_to_json, subnet_to_json,
)
from karpenter_tpu_torch.utils.logging import get_logger

log = get_logger("cloud.stub")


class StubCloudServer:
    """HTTP facade over a FakeCloud (+ optional FakeIKS)."""

    def __init__(self, cloud: FakeCloud | None = None,
                 iks: FakeIKS | None = None,
                 api_key: str = "test-key", host: str = "127.0.0.1",
                 port: int = 0, token_ttl: float = 3600.0):
        self.cloud = cloud or FakeCloud()
        self.iks = iks
        self.api_key = api_key
        self.token_ttl = token_ttl
        self._tokens: dict[str, bool] = {}
        self._lock = threading.Lock()
        handler = _make_handler(self)
        self._server = ThreadingHTTPServer((host, port), handler)
        self.port = self._server.server_address[1]
        self._thread: threading.Thread | None = None

    @property
    def endpoint(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    def start(self) -> "StubCloudServer":
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)

    # -- auth --------------------------------------------------------------

    def issue_token(self, apikey: str) -> dict:
        if apikey != self.api_key:
            raise CloudError("invalid api key", 401, retryable=False)
        token = secrets.token_hex(16)
        with self._lock:
            self._tokens[token] = True
        return {"access_token": token, "expires_in": self.token_ttl}

    def check_token(self, header: str) -> bool:
        if not header.startswith("Bearer "):
            return False
        with self._lock:
            return self._tokens.get(header[len("Bearer "):], False)

    def revoke_all_tokens(self) -> None:
        """Test hook: simulate server-side token expiry -> clients must
        re-auth on the 401."""
        with self._lock:
            self._tokens.clear()

    # -- routing -----------------------------------------------------------

    def handle(self, method: str, path: str, query: dict, body: dict) -> dict:
        """Dispatch a request to the backing fakes.  Returns the JSON
        response dict; raises CloudError for API-level failures."""
        parts = [p for p in path.split("/") if p]
        cloud = self.cloud

        # ---- VPC plane ----
        if path == "/v1/zones":
            return {"zones": cloud.list_zones()}
        if path == "/v1/instance/profiles":
            return {"profiles": [profile_to_json(p)
                                 for p in cloud.list_instance_profiles()]}
        if len(parts) == 3 and parts[:2] == ["v1", "pricing"]:
            return {"price": cloud.get_pricing(parts[2])}
        if path == "/v1/subnets":
            return {"subnets": [subnet_to_json(s)
                                for s in cloud.list_subnets()]}
        if len(parts) == 3 and parts[:2] == ["v1", "subnets"]:
            return subnet_to_json(cloud.get_subnet(parts[2]))
        if path == "/v1/images":
            return {"images": [image_to_json(m) for m in cloud.list_images()]}
        if path == "/v1/vpcs/default/security_group":
            return {"id": cloud.get_default_security_group()}
        if path == "/v1/security_groups":
            return {"security_groups": cloud.list_security_groups()}
        if path == "/v1/vpcs":
            return {"vpcs": cloud.list_vpcs()}
        if path == "/v1/keys":
            return {"keys": cloud.list_ssh_keys()}
        if path == "/v1/virtual_network_interfaces" and method == "POST":
            vni = cloud.create_vni(
                body.get("subnet_id", ""),
                idempotency_key=body.get("idempotency_key", ""))
            return {"id": vni.id, "subnet_id": vni.subnet_id}
        if path == "/v1/volumes" and method == "POST":
            vol = cloud.create_volume(
                capacity_gb=int(body.get("capacity_gb", 100)),
                profile=body.get("profile", "general-purpose"),
                volume_id=body.get("volume_id", ""),
                idempotency_key=body.get("idempotency_key", ""))
            return {"id": vol.id, "capacity_gb": vol.capacity_gb,
                    "profile": vol.profile}
        if path == "/v1/instances" and method == "POST":
            vols = tuple(Volume(id=v.get("id", ""),
                                capacity_gb=int(v.get("capacity_gb", 100)),
                                profile=v.get("profile", "general-purpose"))
                         for v in body.get("volumes") or ())
            inst = cloud.create_instance(
                name=body.get("name", ""), profile=body.get("profile", ""),
                zone=body.get("zone", ""),
                subnet_id=body.get("subnet_id", ""),
                image_id=body.get("image_id", ""),
                capacity_type=body.get("capacity_type", "on-demand"),
                security_group_ids=tuple(body.get("security_group_ids") or ()),
                user_data=body.get("user_data", ""),
                tags=body.get("tags") or {}, volumes=vols,
                vni_id=body.get("vni_id", ""),
                volume_ids=tuple(body.get("volume_ids") or ()),
                idempotency_key=body.get("idempotency_key", ""))
            return instance_to_json(inst)
        if path == "/v1/instances" and method == "GET":
            if query.get("availability") == ["spot"]:
                return {"instances": [instance_to_json(i)
                                      for i in cloud.list_spot_instances()]}
            return {"instances": [instance_to_json(i)
                                  for i in cloud.list_instances()]}
        if len(parts) == 4 and parts[:2] == ["v1", "instances"] \
                and parts[3] == "tags" and method == "POST":
            cloud.update_tags(parts[2], body.get("tags") or {})
            return {}
        if len(parts) == 3 and parts[:2] == ["v1", "instances"]:
            if method == "GET":
                return instance_to_json(cloud.get_instance(parts[2]))
            if method == "DELETE":
                cloud.delete_instance(parts[2])
                return {}
        if len(parts) == 3 and parts[:2] == ["v1",
                                             "virtual_network_interfaces"] \
                and method == "DELETE":
            cloud.delete_vni(parts[2])
            return {}
        if len(parts) == 3 and parts[:2] == ["v1", "volumes"] \
                and method == "DELETE":
            cloud.delete_volume(parts[2])
            return {}
        if path == "/v1/quota":
            live, limit = cloud.quota_status()
            return {"live": live, "limit": limit}

        # ---- IKS plane ----
        if len(parts) >= 3 and parts[0] == "v2" and parts[1] == "clusters":
            return self._handle_iks(method, parts[2], parts[3:], query, body)

        raise CloudError(f"no route for {method} {path}", 404,
                         retryable=False)

    def _handle_iks(self, method: str, cluster_id: str, rest, query: dict,
                    body: dict) -> dict:
        iks = self.iks
        if iks is None or cluster_id != iks.cluster_id:
            raise CloudError(f"cluster {cluster_id!r} not found", 404,
                             retryable=False)
        if rest == ["workerpools"]:
            if method == "POST":
                return pool_to_json(iks.create_pool(
                    name=body.get("name", ""), flavor=body.get("flavor", ""),
                    zones=list(body.get("zones") or []),
                    size_per_zone=int(body.get("size_per_zone", 0)),
                    labels=body.get("labels") or {},
                    dynamic=bool(body.get("dynamic", False))))
            return {"workerpools": [pool_to_json(p)
                                    for p in iks.list_pools()]}
        if len(rest) == 2 and rest[0] == "workerpools":
            if method == "GET":
                return pool_to_json(iks.get_pool(rest[1]))
            if method == "DELETE":
                iks.delete_pool(rest[1])
                return {}
        if len(rest) == 3 and rest[0] == "workerpools":
            pool_id, action = rest[1], rest[2]
            if action == "zones" and method == "POST":
                iks.add_pool_zone(pool_id, body.get("zone", ""))
                return {}
            if action == "increment" and method == "POST":
                return worker_to_json(
                    iks.increment_pool(pool_id, body.get("zone", "")))
            if action == "decrement" and method == "POST":
                iks.decrement_pool(pool_id, body.get("worker_id", ""))
                return {}
        if rest == ["workers"]:
            if method == "POST":
                return worker_to_json(self._register_worker(body))
            pool = (query.get("pool") or [None])[0]
            return {"workers": [worker_to_json(w)
                                for w in iks.list_workers(pool)]}
        if len(rest) == 2 and rest[0] == "workers" and method == "GET":
            return worker_to_json(iks.get_worker(rest[1]))
        if rest == ["config"]:
            return iks.get_cluster_config()
        raise CloudError(f"no IKS route for {method} /{'/'.join(rest)}", 404,
                         retryable=False)

    def _register_worker(self, body: dict):
        """AddWorkerToIKSCluster analogue: attach an existing VPC instance
        to the cluster as a worker (ref iks_api.go:53)."""
        return self.iks.register_worker(body.get("instance_id", ""),
                                        body.get("pool_id", ""))


def _make_handler(stub: StubCloudServer):
    class Handler(BaseHTTPRequestHandler):
        # silence per-request logging
        def log_message(self, *args):
            pass

        def _read_body(self) -> dict:
            length = int(self.headers.get("Content-Length") or 0)
            if not length:
                return {}
            try:
                return json.loads(self.rfile.read(length))
            except json.JSONDecodeError:
                return {}

        def _send(self, status: int, payload: dict,
                  headers: dict | None = None) -> None:
            data = json.dumps(payload).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(data)

        def _dispatch(self, method: str) -> None:
            parsed = urlparse(self.path)
            body = self._read_body()
            # token issuance is the one unauthenticated route
            if parsed.path == "/identity/token" and method == "POST":
                try:
                    self._send(200, stub.issue_token(body.get("apikey", "")))
                except CloudError as e:
                    self._send_error(e)
                return
            if not stub.check_token(self.headers.get("Authorization", "")):
                self._send(401, {"errors": [
                    {"message": "invalid or expired token",
                     "code": "unauthorized"}]})
                return
            try:
                self._send(200, stub.handle(method, parsed.path,
                                            parse_qs(parsed.query), body))
            except CloudError as e:
                self._send_error(e)
            except Exception as e:   # stub bug -> visible 500
                log.error("stub handler crashed", method=method,
                          path=parsed.path, error=str(e))
                self._send(500, {"errors": [{"message": str(e),
                                             "code": "internal_error"}]})

        def _send_error(self, e: CloudError) -> None:
            headers = {}
            if e.retry_after:
                headers["Retry-After"] = str(int(e.retry_after))
            elif e.status_code == 429:
                headers["Retry-After"] = "1"
            self._send(e.status_code or 500,
                       {"errors": [{"message": e.message, "code": e.code}]},
                       headers)

        def do_GET(self):
            self._dispatch("GET")

        def do_POST(self):
            self._dispatch("POST")

        def do_DELETE(self):
            self._dispatch("DELETE")

    return Handler
