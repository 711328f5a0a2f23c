"""The ``ssd_search`` kernel (``vo/semi_dense/csrc/ssd_search.cu``):
the least time the card needs for what each call's inputs need, summed
over the profiled frames' calls, over the device time of the
operations whose name holds ``ssd_search``, in %.  Bytes and
operations come from the frozen yardstick (``harness/roofline.py``),
so the share is the same whatever design runs the search.  Moves
``fps``."""

from bench_port.harness.roofline import bound_s, ssd_search_work

UNIT = "%"


def read(record):
    calls = record.calls.get("ssd_search", [])
    kernel_s = record.device_time("ssd_search")
    if not calls or kernel_s <= 0:
        return None
    need = sum(bound_s(*ssd_search_work(V, mlo, mhi))
               for V, K, mlo, mhi in calls)
    return 100.0 * need / kernel_s
