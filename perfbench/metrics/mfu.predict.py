"""The whole predict's share of the chip's peak, in %: the convolution and
matrix-product FLOPs of the forward of every image of the traced run's
timing pass, counted by ``FlopCounterMode`` over the frozen reference at
each image's canvas, over that pass's window and the configuration's
peak."""


def read(rec):
    if not rec.get('flops') or rec['window_s'] <= 0:
        return None
    return 100.0 * rec['flops'] / rec['window_s'] / rec['peak_flops']
