"""A cell's configuration cut to 120x160 for CPU tests: the image and
the intrinsics scaled by 1/4."""


def small(config, scale=4):
    config = dict(config)
    H, W = config["image_shape"]
    config["image_shape"] = [H // scale, W // scale]
    camera = dict(config["camera"])
    for key in ("fx", "fy", "cx", "cy"):
        camera[key] = camera[key] / scale
    config["camera"] = camera
    return config
