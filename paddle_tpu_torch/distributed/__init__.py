"""Distributed planes of the PyTorch port.

- :mod:`faults` — the chaos suite's fault injection, whose hooks the
  decode engine, the serving batcher and the transport call;
- :mod:`serde` — the wire's binary form of dense tensors and
  ``SelectedRows`` (byte for byte the reference's);
- :mod:`transport` — the framed-TCP RPC client and server, on the
  native C backend (``native/paddle_tpu_native.cc``) or stdlib sockets
  (``FLAGS_rpc_transport``);
- :mod:`registry` — TTL-lease discovery and the fleet health table the
  serving and decode replicas announce into;
- :mod:`supervisor` — the self-healing fleet supervisor, for stateless
  roles (its module doc).

All but ``supervisor`` are copies of the reference's modules (``serde``
converts torch tensors at the boundary).  The parameter-server stack
(pserver, master, transpiler) and the supervisor's rollback roles are
still to port.
"""
from . import faults, serde, supervisor, transport  # noqa: F401
from .supervisor import FleetSpec, RoleSpec, Supervisor  # noqa: F401
from .transport import wait_server_ready  # noqa: F401

__all__ = ["FleetSpec", "RoleSpec", "Supervisor", "faults", "serde",
           "supervisor", "transport", "wait_server_ready"]
