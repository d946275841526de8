"""The table of peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at the 700 W limit), and the card's own instruction issue rate."""
import subprocess

HBM_BYTES_PER_S = 3.35e12
FLOPS = {"float32": 67e12}  # the precision the benchmark runs (harness/program.py)
LANES_PER_SM = 128  # one instruction a lane and clock


def card(device) -> dict:
    """The peaks of the card at ``device``: the data sheet's bytes and FLOPs
    a second, and ``issue_ops_per_s``, SMs x 128 lanes x the top SM clock
    that ``nvidia-smi`` reports (a kernel that rounds every product and sum
    on its own issues one instruction an operation), with the card's name
    and power limit."""
    import torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm,power.limit,name",
                          "--format=csv,noheader,nounits", f"--id={device.index or 0}"],
                         capture_output=True, text=True, timeout=60, check=True)
    mhz, watts, name = [x.strip() for x in smi.stdout.strip().split(",", 2)]
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    return {"hbm_bytes_per_s": HBM_BYTES_PER_S, "flops": dict(FLOPS),
            "issue_ops_per_s": n_sm * LANES_PER_SM * float(mhz) * 1e6,
            "sm_count": n_sm, "max_sm_mhz": float(mhz), "power_limit_w": float(watts),
            "name": name}
