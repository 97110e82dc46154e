# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: predictor.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0fpredictor.proto\x12\tpredictor\"X\n\x0eSparseFeatures\x12\x14\n\x0cnum_features\x18\x01 \x01(\x05\x12\x0f\n\x07lengths\x18\x02 \x01(\x0c\x12\x0e\n\x06values\x18\x03 \x01(\x0c\x12\x0f\n\x07weights\x18\x04 \x01(\x0c\"5\n\rFloatFeatures\x12\x14\n\x0cnum_features\x18\x01 \x01(\x05\x12\x0e\n\x06values\x18\x02 \x01(\x0c\"\xb2\x02\n\x11PredictionRequest\x12\x12\n\nbatch_size\x18\x01 \x01(\x05\x12\x30\n\x0e\x66loat_features\x18\x02 \x01(\x0b\x32\x18.predictor.FloatFeatures\x12\x33\n\x10id_list_features\x18\x03 \x01(\x0b\x32\x19.predictor.SparseFeatures\x12\x39\n\x16id_score_list_features\x18\x04 \x01(\x0b\x32\x19.predictor.SparseFeatures\x12\x34\n\x12\x65mbedding_features\x18\x05 \x01(\x0b\x32\x18.predictor.FloatFeatures\x12\x31\n\x0eunary_features\x18\x06 \x01(\x0b\x32\x19.predictor.SparseFeatures\"\x18\n\x08\x46loatVec\x12\x0c\n\x04\x64\x61ta\x18\x01 \x03(\x02\"\xa2\x01\n\x12PredictionResponse\x12\x43\n\x0bpredictions\x18\x01 \x03(\x0b\x32..predictor.PredictionResponse.PredictionsEntry\x1aG\n\x10PredictionsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\"\n\x05value\x18\x02 \x01(\x0b\x32\x13.predictor.FloatVec:\x02\x38\x01\x32U\n\tPredictor\x12H\n\x07Predict\x12\x1c.predictor.PredictionRequest\x1a\x1d.predictor.PredictionResponse\"\x00\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'predictor_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _PREDICTIONRESPONSE_PREDICTIONSENTRY._options = None
  _PREDICTIONRESPONSE_PREDICTIONSENTRY._serialized_options = b'8\001'
  _SPARSEFEATURES._serialized_start=30
  _SPARSEFEATURES._serialized_end=118
  _FLOATFEATURES._serialized_start=120
  _FLOATFEATURES._serialized_end=173
  _PREDICTIONREQUEST._serialized_start=176
  _PREDICTIONREQUEST._serialized_end=482
  _FLOATVEC._serialized_start=484
  _FLOATVEC._serialized_end=508
  _PREDICTIONRESPONSE._serialized_start=511
  _PREDICTIONRESPONSE._serialized_end=673
  _PREDICTIONRESPONSE_PREDICTIONSENTRY._serialized_start=602
  _PREDICTIONRESPONSE_PREDICTIONSENTRY._serialized_end=673
  _PREDICTOR._serialized_start=675
  _PREDICTOR._serialized_end=760
# @@protoc_insertion_point(module_scope)
