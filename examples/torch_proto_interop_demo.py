"""Protobuf wire interop demo on the PyTorch/CUDA port: exchange
SwiftVideo-compatible bytes.  The flow of ``examples/proto_interop_demo.py``.

Builds a composition manifest and a coded media sample, serializes both
to the reference's protobuf wire format (identical field numbers —
Proto/Rpc.public.proto:114-124, Proto/CodedMediaSample.proto:66-90), and
parses them back through the native types.

Run: python examples/torch_proto_interop_demo.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    from swiftvideo_tpu_torch import proto as svproto
    from swiftvideo_tpu_torch.core import TimePoint
    from swiftvideo_tpu_torch.media.coded import (CodedMediaSample, MediaFormat,
                                            MediaType)
    from swiftvideo_tpu_torch.scene import (Composition, Element, ElementState,
                                      Scene)

    if not svproto.available():
        print("google.protobuf not available; demo skipped")
        return

    comp = Composition(
        name="interop-show", canvas_size=(1280, 720),
        scenes=(Scene(name="main", elements=(
            Element(name="camera",
                    initial_state=ElementState(pic_pos=(0, 0),
                                               size=(1280, 720))),
            Element(name="overlay",
                    initial_state=ElementState(pic_pos=(900, 40),
                                               size=(320, 180)),
                    z_index=1))),),
        initial_scene="main")
    manifest = svproto.make_composition_to_wire(comp, epoch=1_700_000_000)
    print(f"RpcMakeComposition wire: {len(manifest)} bytes")
    back, _extra, epoch = svproto.make_composition_from_wire(manifest)
    print(f"  parsed back: {back.name!r}, canvas {back.canvas_size}, "
          f"{len(back.scenes[0].elements)} elements, epoch {epoch}")

    sample = CodedMediaSample(
        buffer=b"\x00\x00\x00\x02\x65\xaa", pts_value=TimePoint(100, 600600),
        dts_value=TimePoint(100, 600600), media_type=MediaType.video,
        media_format=MediaFormat.avc, id_asset="camera",
        id_workspace="studio", side={"config": b"\x01\x64\x00\x1f"})
    wire = svproto.coded_sample_to_wire(sample)
    print(f"CodedMediaSampleWire: {len(wire)} bytes")
    back_s = svproto.coded_sample_from_wire(wire)
    print(f"  parsed back: asset {back_s.asset_id()!r}, "
          f"{back_s.media_format.name}, pts {back_s.pts()}, "
          f"{len(back_s.data())}-byte AU, "
          f"config {back_s.side_data()['config'].hex()}")
    print("proto interop demo OK")


if __name__ == "__main__":
    main()
