"""meng_roofline.train: the Meng 2015 albedo's share of its roofline in the
traced train steps, in percent: the least time of a step's Meng work
(``meng_work.meng_work`` of the run's lanes and the configuration's bounces
and hero wavelengths, against the published FP32 and HBM peaks) over the
device time of the kernels launched inside ``ss.meng`` per step
(``meng_work.device_us_per_step``)."""

from benchmark import meng_work, yardstick


def read(run):
    us = meng_work.device_us_per_step(run)
    if us is None:
        return None
    bounces, n_wavelengths = meng_work.config_shape()
    floor_s = yardstick.bound_s(*meng_work.meng_work(run.facts["k1_rays"], bounces, n_wavelengths))
    return 100.0 * floor_s / (us / 1e6)
