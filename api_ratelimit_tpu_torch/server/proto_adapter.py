"""Port of api_ratelimit_tpu/server/proto_adapter.py: wire <-> models.

gRPC: request_from_v3 / request_from_v2 turn the Envoy protobuf requests
into the internal request, response_to_v3 / response_to_v2 build the
responses, as the reference does (the v2 path converts directly, one hop
fewer than src/service/ratelimit_legacy.go:62-150's v2<->v3 adaption).

/json: the reference converts with protobuf's json_format (Parse into a v3
RateLimitRequest, MessageToJson of a v3 RateLimitResponse). This module
speaks the same proto3 JSON mapping directly with the standard library:

* requests accept each field under its JSON name or its proto name, enums
  as names or numbers, uint32 as a number or a numeric string, and null as
  the default; unknown fields, duplicate keys and wrong types are
  RequestDecodeError (the 400 of the reference's ParseError);
* responses use the JSON names in field-number order, enum names, Duration
  as "<seconds>s", omit fields that hold their default, and are indented by
  two spaces, as MessageToJson emits them.
"""

from __future__ import annotations

import json
from typing import Iterable, Sequence

from ..models.descriptors import Descriptor, Entry, LimitOverride, RateLimitRequest
from ..models.response import Code, DescriptorStatus, HeaderValue
from ..models.units import Unit
from ..pb import rls_v2, rls_v3
from ..service.ratelimit import ServiceError

_UNIT_NAMES = {u.name: int(u) for u in Unit}


class RequestDecodeError(ValueError):
    """The body is not a valid RateLimitRequest in proto3 JSON."""


def _reject_duplicates(pairs):
    out = {}
    for key, value in pairs:
        if key in out:
            raise RequestDecodeError(f"duplicate key {key}")
        out[key] = value
    return out


def _fields(obj, where: str, names: dict[str, str]) -> dict:
    """{proto name: value} of a JSON object whose keys may be JSON or proto
    names; null values are dropped (proto3 default)."""
    if not isinstance(obj, dict):
        raise RequestDecodeError(f"{where}: expected an object")
    out = {}
    for key, value in obj.items():
        name = names.get(key)
        if name is None:
            raise RequestDecodeError(f"{where}: no field named {key!r}")
        if name in out:
            raise RequestDecodeError(f"{where}: field {name} given twice")
        if value is not None:
            out[name] = value
    return out


def _string(value, where: str) -> str:
    if not isinstance(value, str):
        raise RequestDecodeError(f"{where}: expected a string")
    return value


def _uint32(value, where: str) -> int:
    if isinstance(value, bool):
        raise RequestDecodeError(f"{where}: bool is not an integer")
    if isinstance(value, str):
        try:
            value = int(value)
        except ValueError:
            raise RequestDecodeError(f"{where}: not an integer") from None
    if isinstance(value, float):
        if not value.is_integer():
            raise RequestDecodeError(f"{where}: not an integer")
        value = int(value)
    if not isinstance(value, int) or not 0 <= value <= 0xFFFFFFFF:
        raise RequestDecodeError(f"{where}: not a uint32")
    return value


def _unit(value, where: str) -> int:
    if isinstance(value, str):
        if value not in _UNIT_NAMES:
            raise RequestDecodeError(f"{where}: invalid enum value {value}")
        return _UNIT_NAMES[value]
    if isinstance(value, bool) or not isinstance(value, int):
        raise RequestDecodeError(f"{where}: invalid enum value {value!r}")
    if not -(1 << 31) <= value < (1 << 31):
        raise RequestDecodeError(f"{where}: enum value out of range")
    return value  # proto3 enums are open: unknown numbers parse


def _list(value, where: str) -> list:
    if not isinstance(value, list):
        raise RequestDecodeError(f"{where}: expected a list")
    return value


def decode_request(body: bytes) -> RateLimitRequest:
    """POST /json body -> internal request. Raises RequestDecodeError for a
    malformed body, and ServiceError for a limit override whose unit number
    is not a Unit (as request_from_v3 does in the reference)."""
    try:
        obj = json.loads(body, object_pairs_hook=_reject_duplicates)
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise RequestDecodeError(f"invalid JSON: {e}") from None
    top = _fields(
        obj,
        "RateLimitRequest",
        {
            "domain": "domain",
            "descriptors": "descriptors",
            "hitsAddend": "hits_addend",
            "hits_addend": "hits_addend",
        },
    )
    descriptors = []
    for i, d in enumerate(_list(top.get("descriptors", []), "descriptors")):
        where = f"descriptors[{i}]"
        fd = _fields(d, where, {"entries": "entries", "limit": "limit"})
        entries = []
        for j, e in enumerate(_list(fd.get("entries", []), f"{where}.entries")):
            ew = f"{where}.entries[{j}]"
            fe = _fields(e, ew, {"key": "key", "value": "value"})
            entries.append(
                Entry(
                    _string(fe.get("key", ""), f"{ew}.key"),
                    _string(fe.get("value", ""), f"{ew}.value"),
                )
            )
        limit = None
        if "limit" in fd:
            lw = f"{where}.limit"
            fl = _fields(
                fd["limit"],
                lw,
                {
                    "requestsPerUnit": "requests_per_unit",
                    "requests_per_unit": "requests_per_unit",
                    "unit": "unit",
                },
            )
            unit = _unit(fl.get("unit", 0), f"{lw}.unit")
            try:
                unit = Unit(unit)
            except ValueError:
                raise ServiceError(f"invalid limit override unit: {unit}") from None
            limit = LimitOverride(
                requests_per_unit=_uint32(
                    fl.get("requests_per_unit", 0), f"{lw}.requestsPerUnit"
                ),
                unit=unit,
            )
        descriptors.append(Descriptor(entries=tuple(entries), limit=limit))
    return RateLimitRequest(
        domain=_string(top.get("domain", ""), "domain"),
        descriptors=tuple(descriptors),
        hits_addend=_uint32(top.get("hits_addend", 0), "hitsAddend"),
    )


def _status_json(status: DescriptorStatus) -> dict:
    out: dict = {}
    if status.code:
        out["code"] = Code(status.code).name
    limit = status.current_limit
    if limit is not None:
        cl: dict = {}
        if limit.requests_per_unit:
            cl["requestsPerUnit"] = limit.requests_per_unit
        if limit.unit:
            cl["unit"] = Unit(limit.unit).name
        if limit.name:
            cl["name"] = limit.name
        out["currentLimit"] = cl
    if status.limit_remaining:
        out["limitRemaining"] = status.limit_remaining
    if status.duration_until_reset is not None:
        out["durationUntilReset"] = f"{status.duration_until_reset}s"
    return out


def encode_response(
    overall: Code,
    statuses: Sequence[DescriptorStatus],
    headers: Iterable[HeaderValue] = (),
) -> bytes:
    """Internal result -> the RateLimitResponse JSON body."""
    out: dict = {}
    if overall:
        out["overallCode"] = Code(overall).name
    if statuses:
        out["statuses"] = [_status_json(s) for s in statuses]
    header_list = [
        {k: v for k, v in (("key", h.key), ("value", h.value)) if v}
        for h in headers
    ]
    if header_list:
        out["responseHeadersToAdd"] = header_list
    return json.dumps(out, indent=2).encode()


def request_from_v3(msg) -> RateLimitRequest:
    """envoy.service.ratelimit.v3.RateLimitRequest -> internal request.
    Raises ServiceError on malformed fields (proto3 preserves out-of-range
    enum ints) so the transports surface it like any request error."""
    descriptors = []
    for d in msg.descriptors:
        limit = None
        if d.HasField("limit"):
            try:
                unit = Unit(d.limit.unit)
            except ValueError:
                raise ServiceError(
                    f"invalid limit override unit: {d.limit.unit}"
                ) from None
            limit = LimitOverride(
                requests_per_unit=d.limit.requests_per_unit, unit=unit
            )
        descriptors.append(
            Descriptor(
                entries=tuple(Entry(e.key, e.value) for e in d.entries),
                limit=limit,
            )
        )
    return RateLimitRequest(
        domain=msg.domain,
        descriptors=tuple(descriptors),
        hits_addend=msg.hits_addend,
    )


def request_from_v2(msg) -> RateLimitRequest:
    """Legacy request: identical shape minus the per-descriptor override
    (ratelimit_legacy.go:62-92)."""
    return RateLimitRequest(
        domain=msg.domain,
        descriptors=tuple(
            Descriptor(entries=tuple(Entry(e.key, e.value) for e in d.entries))
            for d in msg.descriptors
        ),
        hits_addend=msg.hits_addend,
    )


def _fill_response(
    resp,
    overall: Code,
    statuses: Sequence[DescriptorStatus],
    headers: Iterable[HeaderValue],
    header_field: str,
):
    resp.overall_code = int(overall)
    for status in statuses:
        out = resp.statuses.add()
        out.code = int(status.code)
        out.limit_remaining = status.limit_remaining
        if status.current_limit is not None:
            out.current_limit.requests_per_unit = status.current_limit.requests_per_unit
            out.current_limit.unit = int(status.current_limit.unit)
            if status.current_limit.name:
                out.current_limit.name = status.current_limit.name
        if status.duration_until_reset is not None:
            out.duration_until_reset.seconds = status.duration_until_reset
    field = getattr(resp, header_field)
    for h in headers:
        field.add(key=h.key, value=h.value)
    return resp


def response_to_v3(
    overall: Code,
    statuses: Sequence[DescriptorStatus],
    headers: Iterable[HeaderValue] = (),
):
    return _fill_response(
        rls_v3.RateLimitResponse(),
        overall,
        statuses,
        headers,
        "response_headers_to_add",
    )


def response_to_v2(
    overall: Code,
    statuses: Sequence[DescriptorStatus],
    headers: Iterable[HeaderValue] = (),
):
    """Legacy response; v2 carries the response headers in `headers`
    (ratelimit_legacy.go:94-150)."""
    return _fill_response(
        rls_v2.RateLimitResponse(), overall, statuses, headers, "headers"
    )
