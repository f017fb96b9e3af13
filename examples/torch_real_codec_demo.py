"""Real-codec example on the PyTorch/CUDA port: author an MP4 with real
H.264 + AAC, play it back.  The flow of ``examples/real_codec_demo.py``;
the codecs run on the host, and need ``csrc/libsvav.so``.

End-to-end real-media flow through the in-process libav backend
(csrc/libav_shim.cpp — the same linkage model as the reference's
SwiftFFmpeg modules, dec.video.ffmpeg.swift:24-221): synthetic frames and
a sine tone are encoded with libx264/AAC, muxed into a real MP4 with
libavformat, then the file is opened through the paced FileSource
(file.ffmpeg.swift:44-72 role), demuxed, decoded back, and summarized.

Run: python examples/torch_real_codec_demo.py
"""

import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from swiftvideo_tpu_torch.codec.libav import (LibavAudioEncoder, LibavVideoEncoder,
                                        libav_available)
from swiftvideo_tpu_torch.core import TimePoint


def author_mp4(path: str, n_frames: int = 24, w: int = 192,
               h: int = 108) -> None:
    from swiftvideo_tpu_torch.codec.avformat import MediaFileWriter
    from swiftvideo_tpu_torch.media.audio import AudioSample
    from swiftvideo_tpu_torch.media.coded import MediaFormat
    from swiftvideo_tpu_torch.media.picture import ImageBuffer, PictureSample
    from swiftvideo_tpu_torch.media.pixel import (BufferType, PixelFormat,
                                            planes_for_format)

    venc = LibavVideoEncoder(MediaFormat.avc, bitrate=500_000, fps=30)
    vpkts = []
    for i in range(n_frames):
        yy = ((np.arange(h)[:, None] + np.arange(w)[None, :] * 2 + i * 7)
              % 200 + 20).astype(np.uint8)
        u = np.full((h // 2, w // 2), 90 + (i * 4) % 70, np.uint8)
        v = np.full((h // 2, w // 2), 130 - (i * 2) % 70, np.uint8)
        img = ImageBuffer(PixelFormat.y420p, BufferType.cpu, (w, h),
                          tuple(planes_for_format(PixelFormat.y420p,
                                                  (w, h))), (yy, u, v))
        box = venc(PictureSample(img, "cam", "demo",
                                 pts_value=TimePoint(i * 33, 1000)))
        if box.is_just():
            vpkts.extend(box.value())
    vpkts.extend(venc.flush())
    venc.close()

    aenc = LibavAudioEncoder(MediaFormat.aac, bitrate=96_000)
    apkts = []
    for i in range(n_frames):
        t = (np.arange(1600) + i * 1600) / 48000.0
        wave = (np.sin(2 * np.pi * 440.0 * t) * 11000).astype(np.int16)
        pcm = np.stack([wave, wave // 2], axis=1).reshape(-1).copy()
        box = aenc(AudioSample(buffers=(pcm,), frequency=48000, channels=2,
                               format="s16i", sample_count=1600,
                               id_asset="tone", id_workspace="demo",
                               pts_value=TimePoint(i * 1600, 48000)))
        if box.is_just():
            apkts.extend(box.value())
    apkts.extend(aenc.flush())
    aenc.close()

    with MediaFileWriter(path) as mux:
        vs = mux.add_video_stream(MediaFormat.avc, w, h,
                                  vpkts[0].side_data()["config"])
        as_ = mux.add_audio_stream(MediaFormat.aac, 48000, 2,
                                   apkts[0].side_data()["config"])
        for p in vpkts:
            mux.write(vs, p, duration=TimePoint(33, 1000))
        for p in apkts:
            mux.write(as_, p, duration=TimePoint(1024, 48000))
    print(f"authored {path}: {len(vpkts)} H.264 packets, "
          f"{len(apkts)} AAC packets, {os.path.getsize(path)} bytes")


def play_back(path: str) -> None:
    from swiftvideo_tpu_torch.codec.avformat import MediaFileReader
    from swiftvideo_tpu_torch.codec.libav import (LibavAudioDecoder,
                                            LibavVideoDecoder)
    from swiftvideo_tpu_torch.media.coded import MediaType

    frames, samples = [], []
    vdec, adec = LibavVideoDecoder(), LibavAudioDecoder()
    with MediaFileReader(path) as demux:
        for _idx, pkt in demux.packets():
            if pkt.media_type == MediaType.video:
                box = vdec(pkt)
                if box.is_just():
                    frames.extend(box.value())
            else:
                box = adec(pkt)
                if box.is_just():
                    samples.extend(box.value())
    frames.extend(vdec.flush())
    samples.extend(adec.flush())
    vdec.close()
    adec.close()
    n_audio = sum(a.number_samples() for a in samples)
    pcm = np.concatenate([np.asarray(a.data()[0]).reshape(-1, 2)
                          for a in samples])[:, 0].astype(np.float64)
    # the 440 Hz tone must survive the lossy round trip
    t = np.arange(len(pcm)) / 48000.0
    power = np.hypot(np.mean(pcm * np.sin(2 * np.pi * 440 * t)),
                     np.mean(pcm * np.cos(2 * np.pi * 440 * t)))
    print(f"decoded {len(frames)} frames ({frames[0].size()}), "
          f"{n_audio} audio samples; 440 Hz correlation power "
          f"{power:.0f} (tone {'recovered' if power > 1000 else 'LOST'})")


def main() -> None:
    if not libav_available():
        print("libav shim not available — build with `make -C csrc`")
        return
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "clip.mp4")
        author_mp4(path)
        play_back(path)


if __name__ == "__main__":
    main()
