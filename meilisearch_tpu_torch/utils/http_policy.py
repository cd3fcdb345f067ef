"""Outbound HTTP policy (SSRF guard).

Reference: crates/http-client/src/policy.rs — deny requests to local /
private address ranges unless explicitly allow-listed; applied to embedder,
export, federation, and webhook targets.
"""

from __future__ import annotations

import ipaddress
import os
import socket
import urllib.parse

from ..types.errors import EngineError, ErrorCode


def guarded_urlopen(req, timeout: float = 30):
    """urlopen with the address policy applied.

    Every outbound request (embedders, export, federation proxy, webhooks,
    chat LLM, personalization) goes through this single chokepoint — the
    role of the reference's `http-client` crate wiring (lib.rs:223-241).
    """
    import urllib.request

    url = req.full_url if isinstance(req, urllib.request.Request) else req
    check_url_policy(url)
    return urllib.request.urlopen(req, timeout=timeout)


def allowed_networks() -> list:
    """CIDR allow-list that punches holes in the deny-by-default policy
    (reference: `--experimental-allowed-ip-networks`, option.rs:501 +
    cidr::AnyIpCidr). Set via MEILI_EXPERIMENTAL_ALLOWED_IP_NETWORKS, a
    comma-separated CIDR list (the option loader exports it there)."""
    raw = os.environ.get("MEILI_EXPERIMENTAL_ALLOWED_IP_NETWORKS", "")
    nets = []
    for part in raw.split(","):
        part = part.strip()
        if not part:
            continue
        try:
            nets.append(ipaddress.ip_network(part, strict=False))
        except ValueError:
            pass
    return nets


def check_url_policy(url: str) -> None:
    """Raise when the URL resolves to a non-public address.

    Deny-by-default, matching the reference policy (policy.rs denies
    private/loopback/link-local ranges unless allow-listed).
    MEILI_TPU_ALLOW_LOCAL_URLS=1 disables the guard — the reference's
    `--experimental-allow-private-network` equivalent, needed for tests and
    single-box setups that point webhooks/remotes at localhost.
    """
    if os.environ.get("MEILI_TPU_ALLOW_LOCAL_URLS", "0") == "1":
        return
    parsed = urllib.parse.urlparse(url)
    host = parsed.hostname
    if host is None:
        raise EngineError(ErrorCode.BAD_REQUEST, f"Invalid URL `{url}`.")
    try:
        infos = socket.getaddrinfo(host, None)
    except socket.gaierror:
        raise EngineError(
            ErrorCode.BAD_REQUEST, f"Could not resolve host `{host}`."
        )
    allowed = allowed_networks()
    for info in infos:
        addr = ipaddress.ip_address(info[4][0])
        if any(addr in net for net in allowed):
            continue
        if (
            addr.is_private
            or addr.is_loopback
            or addr.is_link_local
            or addr.is_multicast
            or addr.is_reserved
            or addr.is_unspecified
        ):
            raise EngineError(
                ErrorCode.BAD_REQUEST,
                f"URL `{url}` resolves to a non-public address, which is not"
                " allowed by the network policy.",
            )
