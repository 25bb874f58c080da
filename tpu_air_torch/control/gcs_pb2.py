# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: tpu_air_torch/control/gcs.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x1ftpu_air_torch/control/gcs.proto\x12\x11tpu_air_torch.gcs\"i\n\x08NodeInfo\x12\x0f\n\x07node_id\x18\x01 \x01(\t\x12\x0f\n\x07\x61\x64\x64ress\x18\x02 \x01(\t\x12\x11\n\tnum_chips\x18\x03 \x01(\x05\x12\x19\n\x11last_heartbeat_ms\x18\x04 \x01(\x03\x12\r\n\x05\x61live\x18\x05 \x01(\x08\"\\\n\tActorInfo\x12\x10\n\x08\x61\x63tor_id\x18\x01 \x01(\t\x12\x0c\n\x04name\x18\x02 \x01(\t\x12\x0f\n\x07node_id\x18\x03 \x01(\t\x12\x10\n\x08\x63hip_ids\x18\x04 \x03(\x05\x12\x0c\n\x04\x64\x65\x61\x64\x18\x05 \x01(\x08\"I\n\x0eObjectLocation\x12\x11\n\tobject_id\x18\x01 \x01(\t\x12\x10\n\x08node_ids\x18\x02 \x03(\t\x12\x12\n\nsize_bytes\x18\x03 \x01(\x04\"\x8e\x03\n\x07Request\x12\x0b\n\x03seq\x18\x01 \x01(\x04\x12\x34\n\rregister_node\x18\n \x01(\x0b\x32\x1b.tpu_air_torch.gcs.NodeInfoH\x00\x12\x13\n\theartbeat\x18\x0b \x01(\tH\x00\x12\x14\n\nlist_nodes\x18\x0c \x01(\x08H\x00\x12\x36\n\x0eregister_actor\x18\x14 \x01(\x0b\x32\x1c.tpu_air_torch.gcs.ActorInfoH\x00\x12\x16\n\x0clookup_actor\x18\x15 \x01(\tH\x00\x12\x19\n\x0fmark_actor_dead\x18\x16 \x01(\tH\x00\x12;\n\x0epublish_object\x18\x1e \x01(\x0b\x32!.tpu_air_torch.gcs.ObjectLocationH\x00\x12\x17\n\rlocate_object\x18\x1f \x01(\tH\x00\x12*\n\x06kv_put\x18( \x01(\x0b\x32\x18.tpu_air_torch.gcs.KVPutH\x00\x12\x10\n\x06kv_get\x18) \x01(\tH\x00\x12\x10\n\x06kv_del\x18* \x01(\tH\x00\x42\x04\n\x02op\"#\n\x05KVPut\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\x0c\"\xdb\x01\n\x05Reply\x12\x0b\n\x03seq\x18\x01 \x01(\x04\x12\n\n\x02ok\x18\x02 \x01(\x08\x12\r\n\x05\x65rror\x18\x03 \x01(\t\x12*\n\x05nodes\x18\x04 \x03(\x0b\x32\x1b.tpu_air_torch.gcs.NodeInfo\x12+\n\x05\x61\x63tor\x18\x05 \x01(\x0b\x32\x1c.tpu_air_torch.gcs.ActorInfo\x12\x33\n\x08location\x18\x06 \x01(\x0b\x32!.tpu_air_torch.gcs.ObjectLocation\x12\r\n\x05value\x18\x07 \x01(\x0c\x12\r\n\x05\x66ound\x18\x08 \x01(\x08\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'tpu_air_torch.control.gcs_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _NODEINFO._serialized_start=54
  _NODEINFO._serialized_end=159
  _ACTORINFO._serialized_start=161
  _ACTORINFO._serialized_end=253
  _OBJECTLOCATION._serialized_start=255
  _OBJECTLOCATION._serialized_end=328
  _REQUEST._serialized_start=331
  _REQUEST._serialized_end=729
  _KVPUT._serialized_start=731
  _KVPUT._serialized_end=766
  _REPLY._serialized_start=769
  _REPLY._serialized_end=988
# @@protoc_insertion_point(module_scope)
