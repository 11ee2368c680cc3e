"""Streaming read rate of the card's memory, per storage dtype.

The port's counterpart of the JAX package's ``tools/bench_hbm.py``. The
decode step streams its weights once a step, and every bound in the kernel
table assumes the H100's data-sheet rate of 3.35 TB/s. This probe measures
what a pure streaming reduction reaches on each storage dtype, over an array
the size of a decode weight stream (~1.25 GB):

    step(h) = h + sum(x)     launched REPS times, the scalar carry chained

for bf16, float32 and int8, flat and in a [4096, N] weight-like shape.
``eff_gb_s`` = bytes / time per step. int8 is summed with
``dtype=torch.int32`` and the floats with ``dtype=torch.float32``, as the
JAX probe sums them. ``torch.sum`` is PyTorch's reduction, as ``jnp.sum``
is XLA's: the figure is what that reduction reaches, not the card's
ceiling. On the card each array's ``kernels`` lists the kernels one step
launches (a cast that the reduction makes first shows there).

Each array is drawn on the device from a ``torch.Generator`` and freed
before the next is made. A rate above the data sheet's by more than 5% is
a fault of the timing, and the run fails. The rates feed the other
microbenches' rooflines (``rooflines``), which state each bound twice: at
the data sheet's rate and at the rate measured here.

    python -m sonicscribe_tpu_torch.tools.bench_hbm [--quick] [--device cpu] [--out F]

--quick reads 16 MiB arrays 3 times (a smoke of the code). Prints one JSON
line; writes it to a file only with --out.
"""

from __future__ import annotations

import time

import torch

from sonicscribe_tpu_torch.device import resolve_device
from sonicscribe_tpu_torch.tools.loadtest import bench_parser, device_fields, emit

REPS = 20
GB = 1 << 30
N_BYTES = int(1.25 * GB)  # ~ a nano decoder weight stream, as in the JAX probe
QUICK_BYTES = 16 << 20
QUICK_REPS = 3
ROWS_2D = 4096
DATASHEET_GB_S = 3350.0  # H100 SXM HBM3, NVIDIA's data sheet
# a rate above the data sheet's by more than this share is a timing fault
RATE_SLACK = 1.05
# name -> (dtype, [ROWS_2D, N] shaped)
ARRAYS = {
    "bf16_flat": (torch.bfloat16, False),
    "f32_flat": (torch.float32, False),
    "int8_flat": (torch.int8, False),
    "bf16_2d": (torch.bfloat16, True),
    "int8_2d": (torch.int8, True),
}


def make_array(name: str, n_bytes: int, gen: torch.Generator, device) -> torch.Tensor:
    """The named array of n_bytes, drawn on `device` from `gen`: normal
    floats, int8 codes in [-127, 127)."""
    dtype, two_d = ARRAYS[name]
    n = n_bytes // torch.empty((), dtype=dtype).element_size()
    shape = (ROWS_2D, n // ROWS_2D) if two_d else (n,)
    if dtype == torch.int8:
        return torch.randint(-127, 127, shape, generator=gen, dtype=dtype, device=device)
    return torch.randn(shape, generator=gen, dtype=dtype, device=device)


def read_step(h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """h + sum(x) as a float32 scalar: every step reads all of x."""
    acc = torch.int32 if x.dtype == torch.int8 else torch.float32
    return h + x.sum(dtype=acc).float()


def probe(x: torch.Tensor, reps: int = REPS) -> tuple[float, float]:
    """(GB/s, ms) of read_step over x, `reps` steps chained through the
    carry after one warm step: CUDA events around the steps on the card,
    the host clock on the CPU."""
    h = read_step(torch.zeros((), dtype=torch.float32, device=x.device), x)
    if x.device.type == "cuda":
        torch.cuda.synchronize(x.device)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            h = read_step(h, x)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / reps
    else:
        t0 = time.perf_counter()
        for _ in range(reps):
            h = read_step(h, x)
        float(h)
        ms = (time.perf_counter() - t0) * 1e3 / reps
    return x.numel() * x.element_size() / (ms * 1e-3) / 1e9, ms


def step_kernels(x: torch.Tensor) -> list:
    """The kernels one read step launches on the card, each with its device
    ms (a profile taken again while it holds no kernel record, at most 20
    times)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    h = torch.zeros((), dtype=torch.float32, device=x.device)
    for _ in range(20):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            read_step(h, x)
            torch.cuda.synchronize(x.device)
        events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        if events:
            break
    return [{"name": e.key[:160], "count": e.count,
             "ms": getattr(e, "self_device_time_total", 0.0) / 1e3} for e in events]


def measure(device, n_bytes: int = N_BYTES, reps: int = REPS, names=tuple(ARRAYS),
            seed: int = 0) -> dict:
    """{name: {"eff_gb_s", "ms", "bytes", "kernels"}} for each named array,
    one live at a time. On the card a rate above DATASHEET_GB_S *
    RATE_SLACK raises: the timing is at fault."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    out = {}
    for name in names:
        x = make_array(name, n_bytes, gen, device)
        gb_s, ms = probe(x, reps)
        out[name] = {"eff_gb_s": gb_s, "ms": ms, "bytes": x.numel() * x.element_size(),
                     "kernels": step_kernels(x) if device.type == "cuda" else None}
        del x
        if device.type == "cuda" and gb_s > DATASHEET_GB_S * RATE_SLACK:
            raise RuntimeError(f"{name}: {gb_s:.1f} GB/s is above the data sheet's "
                               f"{DATASHEET_GB_S} GB/s x {RATE_SLACK}: the timing is at fault")
    return out


def measured_rate(device, name: str = "bf16_flat", n_bytes: int = N_BYTES,
                  reps: int = REPS) -> float | None:
    """The read rate (GB/s) of one array on the card, for rooflines; None
    on the CPU, whose memory is not the card's."""
    device = resolve_device(device)
    if device.type != "cuda":
        return None
    return measure(device, n_bytes, reps, (name,))[name]["eff_gb_s"]


def rooflines(name: str, n_bytes: float, rate_gb_s: float | None) -> dict:
    """The least ms to move n_bytes, twice: at the data sheet's rate
    (``roofline_<name>_ms``) and at a measured rate
    (``roofline_<name>_ms_measured``, None without one)."""
    return {f"roofline_{name}_ms": n_bytes / (DATASHEET_GB_S * 1e9) * 1e3,
            f"roofline_{name}_ms_measured": (n_bytes / (rate_gb_s * 1e9) * 1e3
                                             if rate_gb_s else None)}


def main(argv=None) -> None:
    args = bench_parser(__doc__).parse_args(argv)
    n_bytes, reps = (QUICK_BYTES, QUICK_REPS) if args.quick else (N_BYTES, REPS)
    device = resolve_device(args.device)
    results = measure(device, n_bytes, reps)
    emit({"what": "streaming-reduction read rate per storage dtype (torch.sum over one "
                  "array, chained launches); what PyTorch's reduction reaches",
          **device_fields(device), "reps": reps, "datasheet_gb_s": DATASHEET_GB_S,
          **results}, args.out)


if __name__ == "__main__":
    main()
