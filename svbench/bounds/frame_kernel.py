"""Bytes one live frame's composite must move: every source plane read
once, the y420p canvas written once."""


def y420p_bytes(w: int, h: int) -> int:
    return w * h + 2 * (w // 2) * (h // 2)


def bytes_per_frame(config: dict) -> int:
    cams = sum(1 for e in config["elements"] if e["input"] == "camera")
    overlays = sum(1 for e in config["elements"] if e["input"] == "overlay")
    ow, oh = config["overlay"]["size"]
    return (cams * y420p_bytes(*config["camera"]["size"])
            + overlays * ow * oh * 4 + y420p_bytes(*config["canvas"]))
