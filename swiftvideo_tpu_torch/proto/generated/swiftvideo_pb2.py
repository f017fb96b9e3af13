# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: swiftvideo.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x10swiftvideo.proto\x12\nswiftvideo\")\n\tTimePoint\x12\r\n\x05value\x18\x01 \x01(\x03\x12\r\n\x05scale\x18\x02 \x01(\x03\"n\n\nEventError\x12\x0e\n\x06source\x18\x01 \x01(\t\x12\x0c\n\x04\x63ode\x18\x02 \x01(\x05\x12\x0c\n\x04\x64\x65sc\x18\x03 \x01(\t\x12#\n\x04time\x18\x04 \x01(\x0b\x32\x15.swiftvideo.TimePoint\x12\x0f\n\x07\x61ssetId\x18\x05 \x01(\t\"\xf6\x01\n\x10MediaConstituent\x12\x0f\n\x07idAsset\x18\x01 \x01(\t\x12\"\n\x03pts\x18\x03 \x01(\x0b\x32\x15.swiftvideo.TimePoint\x12\"\n\x03\x64ts\x18\x04 \x01(\x0b\x32\x15.swiftvideo.TimePoint\x12\'\n\x08\x64uration\x18\x05 \x01(\x0b\x32\x15.swiftvideo.TimePoint\x12,\n\rnormalizedPts\x18\x06 \x01(\x0b\x32\x15.swiftvideo.TimePoint\x12\x32\n\x0c\x63onstituents\x18\x07 \x03(\x0b\x32\x1c.swiftvideo.MediaConstituent\"\xda\x03\n\x14\x43odedMediaSampleWire\x12\"\n\x03pts\x18\x01 \x01(\x0b\x32\x15.swiftvideo.TimePoint\x12\"\n\x03\x64ts\x18\x02 \x01(\x0b\x32\x15.swiftvideo.TimePoint\x12(\n\teventTime\x18\x03 \x01(\x0b\x32\x15.swiftvideo.TimePoint\x12\x0f\n\x07idAsset\x18\x04 \x01(\t\x12\x13\n\x0bidWorkspace\x18\x05 \x01(\t\x12\x16\n\x0etokenWorkspace\x18\x06 \x01(\t\x12\x0e\n\x06\x62uffer\x18\x07 \x01(\x0c\x12\x38\n\x04side\x18\x08 \x03(\x0b\x32*.swiftvideo.CodedMediaSampleWire.SideEntry\x12(\n\tmediatype\x18\t \x01(\x0e\x32\x15.swiftvideo.MediaType\x12,\n\x0bmediaformat\x18\n \x01(\x0e\x32\x17.swiftvideo.MediaFormat\x12\x0f\n\x07\x65ncoder\x18\x0c \x01(\t\x12\x32\n\x0c\x63onstituents\x18\x0e \x03(\x0b\x32\x1c.swiftvideo.MediaConstituent\x1a+\n\tSideEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\x0c:\x02\x38\x01\"\x1c\n\x04Vec2\x12\t\n\x01x\x18\x01 \x01(\x02\x12\t\n\x01y\x18\x02 \x01(\x02\"\'\n\x04Vec3\x12\t\n\x01x\x18\x01 \x01(\x02\x12\t\n\x01y\x18\x02 \x01(\x02\x12\t\n\x01z\x18\x03 \x01(\x02\"2\n\x04Vec4\x12\t\n\x01x\x18\x01 \x01(\x02\x12\t\n\x01y\x18\x02 \x01(\x02\x12\t\n\x01z\x18\x03 \x01(\x02\x12\t\n\x01w\x18\x04 \x01(\x02\"\xcc\x03\n\x0c\x45lementState\x12 \n\x06picPos\x18\x01 \x01(\x0b\x32\x10.swiftvideo.Vec3\x12\x1e\n\x04size\x18\x02 \x01(\x0b\x32\x10.swiftvideo.Vec2\x12\'\n\rtextureOffset\x18\x03 \x01(\x0b\x32\x10.swiftvideo.Vec2\x12\x10\n\x08rotation\x18\x04 \x01(\x02\x12\x14\n\x0ctransparency\x18\x05 \x01(\x02\x12\x11\n\taudioGain\x18\x06 \x01(\x02\x12\"\n\x08\x61udioPos\x18\x07 \x01(\x0b\x32\x10.swiftvideo.Vec2\x12)\n\tpicAspect\x18\x08 \x01(\x0e\x32\x16.swiftvideo.AspectMode\x12,\n\tpicOrigin\x18\t \x01(\x0e\x32\x19.swiftvideo.PictureOrigin\x12#\n\tfillColor\x18\n \x01(\x0b\x32\x10.swiftvideo.Vec4\x12$\n\nborderSize\x18\x0b \x01(\x0b\x32\x10.swiftvideo.Vec4\x12\x0e\n\x06hidden\x18\x0c \x01(\x08\x12\r\n\x05muted\x18\r \x01(\x08\x12/\n\x0cparentAnchor\x18\x0e \x03(\x0e\x32\x19.swiftvideo.PictureAnchor\"\xa9\x01\n\x07\x45lement\x12/\n\x06states\x18\x01 \x03(\x0b\x32\x1f.swiftvideo.Element.StatesEntry\x12\x14\n\x0cinitialState\x18\x02 \x01(\t\x12\x0e\n\x06parent\x18\x03 \x01(\t\x1aG\n\x0bStatesEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\'\n\x05value\x18\x02 \x01(\x0b\x32\x18.swiftvideo.ElementState:\x02\x38\x01\"\x80\x01\n\x05Scene\x12\x31\n\x08\x65lements\x18\x01 \x03(\x0b\x32\x1f.swiftvideo.Scene.ElementsEntry\x1a\x44\n\rElementsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\"\n\x05value\x18\x02 \x01(\x0b\x32\x13.swiftvideo.Element:\x02\x38\x01\"\x9a\x01\n\x0b\x43omposition\x12\x33\n\x06scenes\x18\x01 \x03(\x0b\x32#.swiftvideo.Composition.ScenesEntry\x12\x14\n\x0cinitialScene\x18\x03 \x01(\t\x1a@\n\x0bScenesEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12 \n\x05value\x18\x02 \x01(\x0b\x32\x11.swiftvideo.Scene:\x02\x38\x01\"\x98\x03\n\x19RpcAssetPermissionRequest\x12/\n\nsourceType\x18\x01 \x01(\x0e\x32\x1b.swiftvideo.MediaSourceType\x12(\n\tmediaType\x18\x02 \x01(\x0e\x32\x15.swiftvideo.MediaType\x12(\n\x07\x66ormats\x18\x03 \x03(\x0e\x32\x17.swiftvideo.MediaFormat\x12\x45\n\x08metadata\x18\x04 \x03(\x0b\x32\x33.swiftvideo.RpcAssetPermissionRequest.MetadataEntry\x12P\n\x0brequestType\x18\x05 \x01(\x0e\x32;.swiftvideo.RpcAssetPermissionRequest.PermissionRequestType\x1a/\n\rMetadataEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\",\n\x15PermissionRequestType\x12\t\n\x05write\x10\x00\x12\x08\n\x04read\x10\x01\"-\n\x1aRpcAssetPermissionResponse\x12\x0f\n\x07granted\x18\x01 \x01(\x08\"\xae\x06\n\x12RpcComposerCommand\x12\x38\n\x08\x63ommands\x18\x01 \x03(\x0b\x32&.swiftvideo.RpcComposerCommand.Command\x1aW\n\x08StateSet\x12\x11\n\telementId\x18\x01 \x01(\t\x12\'\n\x08\x64uration\x18\x02 \x01(\x0b\x32\x15.swiftvideo.TimePoint\x12\x0f\n\x07stateId\x18\x03 \x01(\t\x1a*\n\x04\x42ind\x12\x0f\n\x07\x61ssetId\x18\x01 \x01(\t\x12\x11\n\telementId\x18\x02 \x01(\t\x1ap\n\x04Load\x12\x0b\n\x03uri\x18\x01 \x01(\t\x12\x0f\n\x07\x61ssetId\x18\x02 \x01(\t\x12\x16\n\x0eworkspaceToken\x18\x03 \x01(\t\x12\x0c\n\x04loop\x18\x04 \x01(\x08\x12\x10\n\x08\x61utoplay\x18\x05 \x01(\x08\x12\x12\n\ncloseOnEnd\x18\x06 \x01(\x08\x1aj\n\x04Text\x12\r\n\x05value\x18\x01 \x01(\t\x12\x10\n\x08\x66ontSize\x18\x02 \x01(\x05\x12\x0f\n\x07\x66ontUrl\x18\x03 \x01(\t\x12\x0f\n\x07\x61ssetId\x18\x04 \x01(\t\x12\x1f\n\x05\x63olor\x18\x05 \x01(\x0b\x32\x10.swiftvideo.Vec4\x1a\xfa\x02\n\x07\x43ommand\x12\x35\n\x05\x61\x66ter\x18\x01 \x03(\x0b\x32&.swiftvideo.RpcComposerCommand.Command\x12\r\n\x05ident\x18\x02 \x01(\x05\x12\x0f\n\x05scene\x18\x03 \x01(\tH\x00\x12?\n\x0c\x65lementState\x18\x04 \x01(\x0b\x32\'.swiftvideo.RpcComposerCommand.StateSetH\x00\x12\x33\n\x04\x62ind\x18\x05 \x01(\x0b\x32#.swiftvideo.RpcComposerCommand.BindH\x00\x12\x37\n\x08loadFile\x18\x06 \x01(\x0b\x32#.swiftvideo.RpcComposerCommand.LoadH\x00\x12\x12\n\x08playFile\x18\x07 \x01(\tH\x00\x12\x12\n\x08stopFile\x18\x08 \x01(\tH\x00\x12\x36\n\x07setText\x18\t \x01(\x0b\x32#.swiftvideo.RpcComposerCommand.TextH\x00\x42\t\n\x07\x63ommand\"\xa3\x02\n\x0fRpcEncodeConfig\x12\'\n\x06\x66ormat\x18\x01 \x01(\x0e\x32\x17.swiftvideo.MediaFormat\x12\x0f\n\x07\x62itrate\x18\x02 \x01(\x05\x12/\n\x10keyframeInterval\x18\x03 \x01(\x0b\x32\x15.swiftvideo.TimePoint\x12\x12\n\nsampleRate\x18\x04 \x01(\x05\x12\x14\n\x0c\x63hannelCount\x18\x05 \x01(\x05\x12\x10\n\x08\x62itDepth\x18\x06 \x01(\x05\x12\x39\n\x07options\x18\x07 \x03(\x0b\x32(.swiftvideo.RpcEncodeConfig.OptionsEntry\x1a.\n\x0cOptionsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\"b\n\x13RpcMixerVideoConfig\x12\r\n\x05width\x18\x01 \x01(\x05\x12\x0e\n\x06height\x18\x02 \x01(\x05\x12,\n\rframeDuration\x18\x03 \x01(\x0b\x32\x15.swiftvideo.TimePoint\";\n\x13RpcMixerAudioConfig\x12\x12\n\nsampleRate\x18\x01 \x01(\x05\x12\x10\n\x08\x63hannels\x18\x02 \x01(\x05\"\xbf\x02\n\x12RpcMakeComposition\x12\x12\n\nnewAssetId\x18\x01 \x01(\t\x12\x16\n\x0e\x63hosenInstance\x18\x02 \x01(\t\x12\x32\n\routputConfigs\x18\x03 \x03(\x0b\x32\x1b.swiftvideo.RpcEncodeConfig\x12.\n\x05video\x18\x04 \x01(\x0b\x32\x1f.swiftvideo.RpcMixerVideoConfig\x12.\n\x05\x61udio\x18\x05 \x01(\x0b\x32\x1f.swiftvideo.RpcMixerAudioConfig\x12,\n\x08\x66\x65\x61tures\x18\x06 \x03(\x0e\x32\x1a.swiftvideo.RpcFeatureType\x12,\n\x0b\x63omposition\x18\x07 \x01(\x0b\x32\x17.swiftvideo.Composition\x12\r\n\x05\x65poch\x18\x08 \x01(\x03*D\n\tMediaType\x12\t\n\x05video\x10\x00\x12\t\n\x05\x61udio\x10\x01\x12\t\n\x05image\x10\x02\x12\x08\n\x04\x64\x61ta\x10\x03\x12\x0c\n\x08subtitle\x10\x04*\xb1\x01\n\x0bMediaFormat\x12\x07\n\x03\x61vc\x10\x00\x12\x08\n\x04hevc\x10\x01\x12\x07\n\x03\x61\x61\x63\x10\x02\x12\x08\n\x04opus\x10\x03\x12\x07\n\x03\x61v1\x10\x04\x12\x07\n\x03vp8\x10\x05\x12\x07\n\x03vp9\x10\x06\x12\x10\n\x0cuncompressed\x10\x07\x12\x07\n\x03png\x10\x08\x12\x08\n\x04\x61png\x10\t\x12\x07\n\x03jpg\x10\n\x12\x07\n\x03gif\x10\x0b\x12\x07\n\x03klv\x10\x0c\x12\x07\n\x03srt\x10\r\x12\n\n\x06webvtt\x10\x0e\x12\x0c\n\x08utf8Text\x10\x0f*\xa4\x01\n\x0fMediaSourceType\x12\x08\n\x04rtmp\x10\x00\x12\n\n\x06webrtc\x10\x01\x12\x0b\n\x07httpPut\x10\x02\x12\x0c\n\x08protobuf\x10\x03\x12\x0b\n\x07httpGet\x10\x04\x12\r\n\ttranscode\x10\x05\x12\x0f\n\x0b\x63omposition\x10\x06\x12\x07\n\x03web\x10\x07\x12\n\n\x06output\x10\x08\x12\n\n\x06\x66lavor\x10\t\x12\x08\n\x04\x66ile\x10\n\x12\x08\n\x04text\x10\x0b*;\n\nAspectMode\x12\x0e\n\naspectNone\x10\x00\x12\r\n\taspectFit\x10\x01\x12\x0e\n\naspectFill\x10\x02*4\n\rPictureOrigin\x12\x10\n\x0coriginCenter\x10\x00\x12\x11\n\roriginTopLeft\x10\x01*c\n\rPictureAnchor\x12\x11\n\ranchorTopLeft\x10\x00\x12\x12\n\x0e\x61nchorTopRight\x10\x01\x12\x14\n\x10\x61nchorBottomLeft\x10\x02\x12\x15\n\x11\x61nchorBottomRight\x10\x03*p\n\x0eRpcFeatureType\x12\x0e\n\ntranscoder\x10\x00\x12\x0e\n\ncompositor\x10\x01\x12\x0e\n\nsubtractor\x10\x02\x12\x0e\n\nrtmpOutput\x10\x03\x12\x0b\n\x07\x62rowser\x10\x04\x12\x11\n\rproprietaryIO\x10\x05\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'swiftvideo_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _CODEDMEDIASAMPLEWIRE_SIDEENTRY._options = None
  _CODEDMEDIASAMPLEWIRE_SIDEENTRY._serialized_options = b'8\001'
  _ELEMENT_STATESENTRY._options = None
  _ELEMENT_STATESENTRY._serialized_options = b'8\001'
  _SCENE_ELEMENTSENTRY._options = None
  _SCENE_ELEMENTSENTRY._serialized_options = b'8\001'
  _COMPOSITION_SCENESENTRY._options = None
  _COMPOSITION_SCENESENTRY._serialized_options = b'8\001'
  _RPCASSETPERMISSIONREQUEST_METADATAENTRY._options = None
  _RPCASSETPERMISSIONREQUEST_METADATAENTRY._serialized_options = b'8\001'
  _RPCENCODECONFIG_OPTIONSENTRY._options = None
  _RPCENCODECONFIG_OPTIONSENTRY._serialized_options = b'8\001'
  _MEDIATYPE._serialized_start=4011
  _MEDIATYPE._serialized_end=4079
  _MEDIAFORMAT._serialized_start=4082
  _MEDIAFORMAT._serialized_end=4259
  _MEDIASOURCETYPE._serialized_start=4262
  _MEDIASOURCETYPE._serialized_end=4426
  _ASPECTMODE._serialized_start=4428
  _ASPECTMODE._serialized_end=4487
  _PICTUREORIGIN._serialized_start=4489
  _PICTUREORIGIN._serialized_end=4541
  _PICTUREANCHOR._serialized_start=4543
  _PICTUREANCHOR._serialized_end=4642
  _RPCFEATURETYPE._serialized_start=4644
  _RPCFEATURETYPE._serialized_end=4756
  _TIMEPOINT._serialized_start=32
  _TIMEPOINT._serialized_end=73
  _EVENTERROR._serialized_start=75
  _EVENTERROR._serialized_end=185
  _MEDIACONSTITUENT._serialized_start=188
  _MEDIACONSTITUENT._serialized_end=434
  _CODEDMEDIASAMPLEWIRE._serialized_start=437
  _CODEDMEDIASAMPLEWIRE._serialized_end=911
  _CODEDMEDIASAMPLEWIRE_SIDEENTRY._serialized_start=868
  _CODEDMEDIASAMPLEWIRE_SIDEENTRY._serialized_end=911
  _VEC2._serialized_start=913
  _VEC2._serialized_end=941
  _VEC3._serialized_start=943
  _VEC3._serialized_end=982
  _VEC4._serialized_start=984
  _VEC4._serialized_end=1034
  _ELEMENTSTATE._serialized_start=1037
  _ELEMENTSTATE._serialized_end=1497
  _ELEMENT._serialized_start=1500
  _ELEMENT._serialized_end=1669
  _ELEMENT_STATESENTRY._serialized_start=1598
  _ELEMENT_STATESENTRY._serialized_end=1669
  _SCENE._serialized_start=1672
  _SCENE._serialized_end=1800
  _SCENE_ELEMENTSENTRY._serialized_start=1732
  _SCENE_ELEMENTSENTRY._serialized_end=1800
  _COMPOSITION._serialized_start=1803
  _COMPOSITION._serialized_end=1957
  _COMPOSITION_SCENESENTRY._serialized_start=1893
  _COMPOSITION_SCENESENTRY._serialized_end=1957
  _RPCASSETPERMISSIONREQUEST._serialized_start=1960
  _RPCASSETPERMISSIONREQUEST._serialized_end=2368
  _RPCASSETPERMISSIONREQUEST_METADATAENTRY._serialized_start=2275
  _RPCASSETPERMISSIONREQUEST_METADATAENTRY._serialized_end=2322
  _RPCASSETPERMISSIONREQUEST_PERMISSIONREQUESTTYPE._serialized_start=2324
  _RPCASSETPERMISSIONREQUEST_PERMISSIONREQUESTTYPE._serialized_end=2368
  _RPCASSETPERMISSIONRESPONSE._serialized_start=2370
  _RPCASSETPERMISSIONRESPONSE._serialized_end=2415
  _RPCCOMPOSERCOMMAND._serialized_start=2418
  _RPCCOMPOSERCOMMAND._serialized_end=3232
  _RPCCOMPOSERCOMMAND_STATESET._serialized_start=2498
  _RPCCOMPOSERCOMMAND_STATESET._serialized_end=2585
  _RPCCOMPOSERCOMMAND_BIND._serialized_start=2587
  _RPCCOMPOSERCOMMAND_BIND._serialized_end=2629
  _RPCCOMPOSERCOMMAND_LOAD._serialized_start=2631
  _RPCCOMPOSERCOMMAND_LOAD._serialized_end=2743
  _RPCCOMPOSERCOMMAND_TEXT._serialized_start=2745
  _RPCCOMPOSERCOMMAND_TEXT._serialized_end=2851
  _RPCCOMPOSERCOMMAND_COMMAND._serialized_start=2854
  _RPCCOMPOSERCOMMAND_COMMAND._serialized_end=3232
  _RPCENCODECONFIG._serialized_start=3235
  _RPCENCODECONFIG._serialized_end=3526
  _RPCENCODECONFIG_OPTIONSENTRY._serialized_start=3480
  _RPCENCODECONFIG_OPTIONSENTRY._serialized_end=3526
  _RPCMIXERVIDEOCONFIG._serialized_start=3528
  _RPCMIXERVIDEOCONFIG._serialized_end=3626
  _RPCMIXERAUDIOCONFIG._serialized_start=3628
  _RPCMIXERAUDIOCONFIG._serialized_end=3687
  _RPCMAKECOMPOSITION._serialized_start=3690
  _RPCMAKECOMPOSITION._serialized_end=4009
# @@protoc_insertion_point(module_scope)
