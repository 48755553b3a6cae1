# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: envoy/extensions/common/ratelimit/v3/ratelimit.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n4envoy/extensions/common/ratelimit/v3/ratelimit.proto\x12$envoy.extensions.common.ratelimit.v3\"\xdb\x02\n\x13RateLimitDescriptor\x12P\n\x07\x65ntries\x18\x01 \x03(\x0b\x32?.envoy.extensions.common.ratelimit.v3.RateLimitDescriptor.Entry\x12Z\n\x05limit\x18\x02 \x01(\x0b\x32K.envoy.extensions.common.ratelimit.v3.RateLimitDescriptor.RateLimitOverride\x1a#\n\x05\x45ntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t\x1aq\n\x11RateLimitOverride\x12\x19\n\x11requests_per_unit\x18\x01 \x01(\r\x12\x41\n\x04unit\x18\x02 \x01(\x0e\x32\x33.envoy.extensions.common.ratelimit.v3.RateLimitUnit*G\n\rRateLimitUnit\x12\x0b\n\x07UNKNOWN\x10\x00\x12\n\n\x06SECOND\x10\x01\x12\n\n\x06MINUTE\x10\x02\x12\x08\n\x04HOUR\x10\x03\x12\x07\n\x03\x44\x41Y\x10\x04\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'envoy.extensions.common.ratelimit.v3.ratelimit_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _RATELIMITUNIT._serialized_start=444
  _RATELIMITUNIT._serialized_end=515
  _RATELIMITDESCRIPTOR._serialized_start=95
  _RATELIMITDESCRIPTOR._serialized_end=442
  _RATELIMITDESCRIPTOR_ENTRY._serialized_start=292
  _RATELIMITDESCRIPTOR_ENTRY._serialized_end=327
  _RATELIMITDESCRIPTOR_RATELIMITOVERRIDE._serialized_start=329
  _RATELIMITDESCRIPTOR_RATELIMITOVERRIDE._serialized_end=442
# @@protoc_insertion_point(module_scope)
