"""Device ms a step of the kernels the program launches inside its span
`model.decoder` (`models/groupfree.py`: the decoder's key and query
projections, its layers and their prediction heads, forward only), from
the traced section: each kernel tied to its launch by its correlation id
(`harness/drivers/train_groupfree.py::range_device_s`), summed over the
traced steps, over them."""


def read(r):
    if not r.profile or not r.traced_units:
        return None
    s = r.profile.get("decoder_device_s")
    return None if s is None else s / r.traced_units * 1e3
