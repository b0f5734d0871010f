# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: vdb.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from google.protobuf import empty_pb2 as google_dot_protobuf_dot_empty__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\tvdb.proto\x12\x03vdb\x1a\x1bgoogle/protobuf/empty.proto\"$\n\x06Vector\x12\n\n\x02id\x18\x01 \x01(\x04\x12\x0e\n\x06values\x18\x02 \x03(\x02\"\xc3\x01\n\rSearchRequest\x12\x1c\n\x07queries\x18\x01 \x03(\x0b\x32\x0b.vdb.Vector\x12\x0c\n\x04topk\x18\x02 \x01(\x05\x12\x0e\n\x06nprobe\x18\x03 \x01(\x05\x12\r\n\x05index\x18\x04 \x01(\t\x12\x0e\n\x06metric\x18\x05 \x01(\t\x12\x14\n\x0crerank_exact\x18\x06 \x01(\x08\x12\x10\n\x08priority\x18\x07 \x01(\x05\x12\x16\n\x0epacked_queries\x18\x08 \x01(\x0c\x12\x17\n\x0fpacked_response\x18\t \x01(\x08\"(\n\x08Neighbor\x12\n\n\x02id\x18\x01 \x01(\x04\x12\x10\n\x08\x64istance\x18\x02 \x01(\x02\"0\n\x0cSearchResult\x12 \n\tneighbors\x18\x01 \x03(\x0b\x32\r.vdb.Neighbor\"b\n\x0eSearchResponse\x12\"\n\x07results\x18\x01 \x03(\x0b\x32\x11.vdb.SearchResult\x12\x12\n\npacked_ids\x18\x02 \x01(\x0c\x12\x18\n\x10packed_distances\x18\x03 \x01(\x0c\"-\n\rWarmupRequest\x12\r\n\x05index\x18\x01 \x01(\t\x12\r\n\x05lists\x18\x02 \x03(\x05\"0\n\x10LoadIndexRequest\x12\r\n\x05index\x18\x01 \x01(\t\x12\r\n\x05\x65poch\x18\x02 \x01(\t\"|\n\x12\x43reateIndexRequest\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x11\n\tdimension\x18\x02 \x01(\x05\x12\x0e\n\x06metric\x18\x03 \x01(\t\x12\r\n\x05nlist\x18\x04 \x01(\x05\x12\t\n\x01m\x18\x05 \x01(\x05\x12\r\n\x05nbits\x18\x06 \x01(\x05\x12\x0c\n\x04tier\x18\x07 \x01(\t\"7\n\x11\x42uildEpochRequest\x12\r\n\x05index\x18\x01 \x01(\t\x12\x13\n\x0bsource_path\x18\x02 \x01(\t\"4\n\x14\x41\x63tivateEpochRequest\x12\r\n\x05index\x18\x01 \x01(\t\x12\r\n\x05\x65poch\x18\x02 \x01(\t\",\n\x0cStatsRequest\x12\r\n\x05index\x18\x01 \x01(\t\x12\r\n\x05reset\x18\x02 \x01(\x08\"\xcb\x01\n\rStatsResponse\x12\x15\n\rtotal_vectors\x18\x01 \x01(\x04\x12\x17\n\x0findexed_vectors\x18\x02 \x01(\x04\x12\x15\n\rcurrent_epoch\x18\x03 \x01(\t\x12\x17\n\x0fgpu_memory_used\x18\x04 \x01(\x02\x12\x12\n\nnvme_usage\x18\x05 \x01(\x02\x12\x16\n\x0elatency_p50_ms\x18\x06 \x01(\x02\x12\x16\n\x0elatency_p95_ms\x18\x07 \x01(\x02\x12\x16\n\x0elatency_p99_ms\x18\x08 \x01(\x02\"@\n\x11\x41\x64\x64VectorsRequest\x12\r\n\x05index\x18\x01 \x01(\t\x12\x1c\n\x07vectors\x18\x02 \x03(\x0b\x32\x0b.vdb.Vector\"2\n\x12\x41\x64\x64VectorsResponse\x12\r\n\x05\x61\x64\x64\x65\x64\x18\x01 \x01(\x04\x12\r\n\x05total\x18\x02 \x01(\x04\"2\n\x14RemoveVectorsRequest\x12\r\n\x05index\x18\x01 \x01(\t\x12\x0b\n\x03ids\x18\x02 \x03(\x04\"7\n\x15RemoveVectorsResponse\x12\x0f\n\x07removed\x18\x01 \x01(\x04\x12\r\n\x05total\x18\x02 \x01(\x04\x32\xf0\x01\n\x0cQueryService\x12\x31\n\x06Search\x12\x12.vdb.SearchRequest\x1a\x13.vdb.SearchResponse\x12;\n\x0cStreamSearch\x12\x12.vdb.SearchRequest\x1a\x13.vdb.SearchResponse(\x01\x30\x01\x12\x34\n\x06Warmup\x12\x12.vdb.WarmupRequest\x1a\x16.google.protobuf.Empty\x12:\n\tLoadIndex\x12\x15.vdb.LoadIndexRequest\x1a\x16.google.protobuf.Empty2\x8a\x03\n\x0c\x41\x64minService\x12>\n\x0b\x43reateIndex\x12\x17.vdb.CreateIndexRequest\x1a\x16.google.protobuf.Empty\x12<\n\nBuildEpoch\x12\x16.vdb.BuildEpochRequest\x1a\x16.google.protobuf.Empty\x12\x42\n\rActivateEpoch\x12\x19.vdb.ActivateEpochRequest\x1a\x16.google.protobuf.Empty\x12\x31\n\x08GetStats\x12\x11.vdb.StatsRequest\x1a\x12.vdb.StatsResponse\x12=\n\nAddVectors\x12\x16.vdb.AddVectorsRequest\x1a\x17.vdb.AddVectorsResponse\x12\x46\n\rRemoveVectors\x12\x19.vdb.RemoveVectorsRequest\x1a\x1a.vdb.RemoveVectorsResponseb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'vdb_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _VECTOR._serialized_start=47
  _VECTOR._serialized_end=83
  _SEARCHREQUEST._serialized_start=86
  _SEARCHREQUEST._serialized_end=281
  _NEIGHBOR._serialized_start=283
  _NEIGHBOR._serialized_end=323
  _SEARCHRESULT._serialized_start=325
  _SEARCHRESULT._serialized_end=373
  _SEARCHRESPONSE._serialized_start=375
  _SEARCHRESPONSE._serialized_end=473
  _WARMUPREQUEST._serialized_start=475
  _WARMUPREQUEST._serialized_end=520
  _LOADINDEXREQUEST._serialized_start=522
  _LOADINDEXREQUEST._serialized_end=570
  _CREATEINDEXREQUEST._serialized_start=572
  _CREATEINDEXREQUEST._serialized_end=696
  _BUILDEPOCHREQUEST._serialized_start=698
  _BUILDEPOCHREQUEST._serialized_end=753
  _ACTIVATEEPOCHREQUEST._serialized_start=755
  _ACTIVATEEPOCHREQUEST._serialized_end=807
  _STATSREQUEST._serialized_start=809
  _STATSREQUEST._serialized_end=853
  _STATSRESPONSE._serialized_start=856
  _STATSRESPONSE._serialized_end=1059
  _ADDVECTORSREQUEST._serialized_start=1061
  _ADDVECTORSREQUEST._serialized_end=1125
  _ADDVECTORSRESPONSE._serialized_start=1127
  _ADDVECTORSRESPONSE._serialized_end=1177
  _REMOVEVECTORSREQUEST._serialized_start=1179
  _REMOVEVECTORSREQUEST._serialized_end=1229
  _REMOVEVECTORSRESPONSE._serialized_start=1231
  _REMOVEVECTORSRESPONSE._serialized_end=1286
  _QUERYSERVICE._serialized_start=1289
  _QUERYSERVICE._serialized_end=1529
  _ADMINSERVICE._serialized_start=1532
  _ADMINSERVICE._serialized_end=1926
# @@protoc_insertion_point(module_scope)
