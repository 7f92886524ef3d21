"""System and process load from /proc, and the card's memory.

A copy of flame_tpu/utils/load_tracker.py (after the reference's
LoadTracker, utils/load_tracker.h:83-400): system-wide and per-process
CPU utilization from /proc/stat and /proc/<pid>/stat, memory and swap
from /proc/meminfo and /proc/<pid>/status. Where the JAX package reads
its device's memory_stats(), the port reads torch.cuda.mem_get_info and
torch.cuda.memory_allocated for a CUDA device; for the CPU the device
fields are None.
"""

import os
from typing import Dict, NamedTuple, Optional

import torch


class CPULoad(NamedTuple):
    total_pct: float  # system CPU utilization since the last call
    process_pct: float  # this process's share


class MemLoad(NamedTuple):
    sys_total_kb: int
    sys_free_kb: int
    sys_swap_total_kb: int
    sys_swap_free_kb: int
    process_rss_kb: int
    process_swap_kb: int
    # The tracker's CUDA device (None on the CPU): free and total memory
    # of the card, and the bytes this process's allocator holds there.
    device_free_bytes: Optional[int] = None
    device_total_bytes: Optional[int] = None
    device_allocated_bytes: Optional[int] = None


class LoadTracker:
    """Stateful tracker; each cpu() or get() reports utilization since the
    last call. device: the card whose memory mem() and get() report
    (default the current CUDA device); "cpu" reports none."""

    def __init__(self, pid: Optional[int] = None, device="cuda"):
        self.pid = pid or os.getpid()
        self.device = torch.device(device)
        self._last_total = None
        self._last_idle = None
        self._last_proc = None

    def _read_stat(self):
        with open("/proc/stat") as f:
            parts = f.readline().split()[1:]
        vals = [int(v) for v in parts]
        idle = vals[3] + (vals[4] if len(vals) > 4 else 0)
        # Only the first 8 fields: guest and guest_nice (9, 10) are already
        # folded into user and nice, and would count guest time twice.
        return sum(vals[:8]), idle

    def _read_proc_stat(self):
        with open(f"/proc/{self.pid}/stat") as f:
            parts = f.read().rsplit(")", 1)[1].split()
        # utime + stime are fields 14 and 15 (1-indexed); after ')' they
        # are at offsets 11 and 12.
        return int(parts[11]) + int(parts[12])

    def cpu(self) -> CPULoad:
        total, idle = self._read_stat()
        proc = self._read_proc_stat()
        if self._last_total is None:
            self._last_total, self._last_idle, self._last_proc = \
                total, idle, proc
            return CPULoad(0.0, 0.0)
        dt = max(total - self._last_total, 1)
        didle = idle - self._last_idle
        dproc = proc - self._last_proc
        self._last_total, self._last_idle, self._last_proc = total, idle, proc
        return CPULoad(total_pct=100.0 * (dt - didle) / dt,
                       process_pct=100.0 * dproc / dt)

    def device_memory(self) -> Optional[Dict[str, int]]:
        """free, total, allocated and peak allocated bytes of the card;
        None for the CPU."""
        if self.device.type != "cuda":
            return None
        free, total = torch.cuda.mem_get_info(self.device)
        return {"free_bytes": int(free), "total_bytes": int(total),
                "allocated_bytes": int(torch.cuda.memory_allocated(
                    self.device)),
                "peak_allocated_bytes": int(torch.cuda.max_memory_allocated(
                    self.device))}

    def mem(self) -> MemLoad:
        info: Dict[str, int] = {}
        with open("/proc/meminfo") as f:
            for line in f:
                k, v = line.split(":", 1)
                info[k] = int(v.strip().split()[0])
        rss = swap = 0
        with open(f"/proc/{self.pid}/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    rss = int(line.split()[1])
                elif line.startswith("VmSwap:"):
                    swap = int(line.split()[1])
        dm = self.device_memory() or {}
        return MemLoad(
            sys_total_kb=info.get("MemTotal", 0),
            sys_free_kb=info.get("MemAvailable", info.get("MemFree", 0)),
            sys_swap_total_kb=info.get("SwapTotal", 0),
            sys_swap_free_kb=info.get("SwapFree", 0),
            process_rss_kb=rss, process_swap_kb=swap,
            device_free_bytes=dm.get("free_bytes"),
            device_total_bytes=dm.get("total_bytes"),
            device_allocated_bytes=dm.get("allocated_bytes"))

    def get(self) -> Dict[str, float]:
        cpu = self.cpu()
        mem = self.mem()
        out = {
            "cpu_total_pct": cpu.total_pct,
            "cpu_process_pct": cpu.process_pct,
            "mem_sys_used_kb": mem.sys_total_kb - mem.sys_free_kb,
            "mem_sys_total_kb": mem.sys_total_kb,
            "mem_process_rss_kb": mem.process_rss_kb,
            "swap_used_kb": mem.sys_swap_total_kb - mem.sys_swap_free_kb,
        }
        for k, v in (self.device_memory() or {}).items():
            out[f"device_{k}"] = v
        return out
