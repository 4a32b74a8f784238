"""Batch orchestrator — API parity with ``process_audio_batches_v2``
(reference ``audio_processing_framework.py:580-899``), batched device execution.

Where the reference fans files out to a ``ProcessPoolExecutor``, this
orchestrator keeps one process and vectorizes on device: processors that
implement ``run_batch(audio_matrix, params) -> list[(results, state)]`` get
the whole batch as a single ``(B, N)`` array -> one compiled XLA program
(optionally sharded over a device mesh by the caller, see ``parallel``).
Processors without ``run_batch`` fall back to the per-file loop.

Retained reference semantics:
  * key discovery / loading via injectable ``get_keys_fn`` /
    ``get_input_data_fn`` seams,
  * per-processor param merge (``params_global`` + ``params_by_processor``)
    with dynamic ``_param_updates`` chain propagation,
  * ``<name>__<metric>`` namespacing, ``rain__predicted`` / ``rain__mismatch``,
  * periodic parquet spill + restore, ``DataFrame.attrs`` wall-time metrics.
"""

from __future__ import annotations

import gc
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import pandas as pd

from audio_processing_tools_tpu.io.audio import (
    get_keys as default_get_keys,
    get_input_data as default_get_input_data,
)
from audio_processing_tools_tpu.framework.parquet_io import (  # noqa: F401
    flush_saved_batches,
    restore_state_df_from_parquet,  # re-exported
)

__all__ = [
    "process_audio_batches_v2",
    "process_audio_batches",
    "restore_state_df_from_parquet",
]


def _log_memory_usage(prefix: str = "") -> None:
    """RSS of main + child processes via psutil
    (``audio_processing_framework.py:348-370``)."""
    try:
        import os as _os

        import psutil
    except ImportError:
        print(f"{prefix} psutil not available for memory logging")
        return
    try:
        proc = psutil.Process(_os.getpid())
        main_mb = proc.memory_info().rss / 1024**2
        child_mb = 0.0
        for c in proc.children(recursive=True):
            try:
                child_mb += c.memory_info().rss / 1024**2
            except Exception:
                pass
        print(
            f"{prefix} memory: main={main_mb:.1f} MB  children={child_mb:.1f} MB"
            f"  total={main_mb + child_mb:.1f} MB"
        )
    except Exception as e:
        print(f"{prefix} memory logging failed: {e}")


def _extract_param_updates(obj: Any) -> Dict[str, Any]:
    """``_param_updates`` convention (``audio_processing_framework.py:102-115``)."""
    if not isinstance(obj, dict):
        return {}
    upd = obj.get("_param_updates")
    return upd if isinstance(upd, dict) else {}


def _flatten_with_namespace(ns: str, d: Dict[str, Any]) -> Dict[str, Any]:
    return {f"{ns}__{k}": v for k, v in d.items()}


def _finish_row(row: Dict[str, Any], rain_actual, rain_min_thr) -> None:
    if ("rain__rain_drops" in row and rain_actual is not None
            and rain_min_thr is not None):
        rain_predicted = bool(row["rain__rain_drops"] > rain_min_thr)
        row["rain__predicted"] = rain_predicted
        row["rain__mismatch"] = rain_predicted != bool(rain_actual)


def _process_single_file(
    *, file_key: str, meta: Dict[str, Any], processors, params_global,
    params_by_processor, required_samples: int, rain_min_thr,
) -> Optional[Dict[str, Any]]:
    """Per-file task (``audio_processing_framework.py:149-221``)."""
    audio = meta.get("file_contents")
    rain_actual = meta.get("raining", None)
    if audio is None:
        return None
    audio = np.asarray(audio)
    if audio.ndim != 1:
        raise ValueError(f"audio for {file_key} must be 1-D, got shape {audio.shape}")
    if audio.size < required_samples:
        return None

    row: Dict[str, Any] = {"file_key": file_key, "rain_actual": rain_actual}
    for mk in ("synthetic_noise_info",):
        if mk in meta:
            row[mk] = meta[mk]

    states: Dict[str, Dict[str, Any]] = {}
    ctx = dict(params_global)
    for proc in processors:
        pp = dict(ctx)
        pp.update(params_by_processor.get(proc.name, {}))
        if hasattr(proc, "setup"):
            proc.setup(pp)
        res, st = proc.run(audio, pp)
        res = dict(res) if isinstance(res, dict) else {"value": res}
        st = dict(st) if isinstance(st, dict) else {"state": st}
        st["file_key"] = file_key
        for mk in ("synthetic_noise_info",):
            if mk in meta:
                st[mk] = meta[mk]
        states[proc.name] = st
        row.update(_flatten_with_namespace(proc.name, res))
        updates = {**_extract_param_updates(res), **_extract_param_updates(st)}
        if updates:
            ctx.update(updates)

    _finish_row(row, rain_actual, rain_min_thr)
    return {"row": row, "states": states}


def _run_batch_device(
    *, dir_content, processors, params_global, params_by_processor,
    required_samples: int, rain_min_thr,
) -> List[Dict[str, Any]]:
    """Device-batched path: one (B, N) array per processor batch call.

    All valid files in the batch are truncated to ``required_samples`` (the
    loader already enforces this duration) and stacked.  Processors expose
    ``run_batch(matrix, params) -> list[(results, state)]``.
    """
    items = [
        (k, m) for k, m in dir_content.items()
        if m.get("file_contents") is not None
        and np.asarray(m["file_contents"]).size >= required_samples
    ]
    if not items:
        return []
    keys = [k for k, _ in items]
    mat = np.stack(
        [np.asarray(m["file_contents"], np.float32)[:required_samples] for _, m in items]
    )

    rows = [
        {"file_key": k, "rain_actual": m.get("raining", None),
         **{mk: m[mk] for mk in ("synthetic_noise_info",) if mk in m}}
        for k, m in items
    ]
    states_all: List[Dict[str, Dict[str, Any]]] = [dict() for _ in items]

    for proc in processors:
        pp = dict(params_global)
        pp.update(params_by_processor.get(proc.name, {}))
        if hasattr(proc, "setup"):
            proc.setup(pp)
        pairs = proc.run_batch(mat, pp)
        for i, (res, st) in enumerate(pairs):
            res = dict(res) if isinstance(res, dict) else {"value": res}
            st = dict(st) if isinstance(st, dict) else {"state": st}
            st["file_key"] = keys[i]
            states_all[i][proc.name] = st
            rows[i].update(_flatten_with_namespace(proc.name, res))

    out = []
    for i, (k, m) in enumerate(items):
        _finish_row(rows[i], m.get("raining", None), rain_min_thr)
        out.append({"row": rows[i], "states": states_all[i]})
    return out


def process_audio_batches_v2(
    *,
    processors: List[Any],
    params_global: Dict[str, Any],
    params_by_processor: Optional[Dict[str, Dict[str, Any]]] = None,
    debug_params: Optional[Dict[str, Any]] = None,
    InputType: Optional[str] = None,
    test_vector_path: Optional[str] = None,
    query: Optional[str] = None,
    adse_engine=None,
    batch_size: int = 1000,
    max_files: Optional[int] = None,
    max_batch_save: int = 10_000,
    batch_save_dir: Optional[str] = "./save_dir",
    batch_save_prefix: str = "audio_processing_dump",
    local_cache: Optional[str] = None,
    localStatus: bool = True,
    get_keys_fn: Optional[Callable[..., List[Dict[str, Any]]]] = None,
    get_input_data_fn: Optional[Callable[..., Dict[str, Dict[str, Any]]]] = None,
    get_input_data_kwargs: Optional[Dict[str, Any]] = None,
) -> Tuple[pd.DataFrame, Dict[str, pd.DataFrame]]:
    """Run processors over a corpus in batches.

    Signature, return shapes, namespacing, parquet spill, and ``.attrs``
    metrics match the reference orchestrator; see the module docstring for
    the execution-model differences.  Set ``debug_params['device_batch']``
    to False to force the per-file path even for batch-capable processors.
    """
    _wall_t0 = time.perf_counter()
    params_by_processor = params_by_processor or {}
    debug_params = debug_params or {}
    get_input_data_kwargs = get_input_data_kwargs or {}

    if max_batch_save is None:
        max_batch_save = 10_000
    if batch_save_dir is not None and max_batch_save <= 0:
        raise ValueError("max_batch_save must be > 0 when batch_save_dir is provided")
    save_dir_path = Path(batch_save_dir) if batch_save_dir is not None else None

    if "sample_rate" not in params_global or "check_duration" not in params_global:
        raise KeyError("params_global must contain 'sample_rate' and 'check_duration'.")
    Fs = params_global["sample_rate"]
    check_duration = params_global["check_duration"]
    required_samples = int(Fs * check_duration)

    get_keys_fn = get_keys_fn or default_get_keys
    get_input_data_fn = get_input_data_fn or default_get_input_data

    keys = get_keys_fn(
        InputType, test_vector_path=test_vector_path, query=query,
        adse_engine=adse_engine, batch_size=batch_size, localStatus=localStatus,
    )
    if max_files is not None:
        if max_files < 0:
            raise ValueError("max_files must be >= 0 or None")
        keys = keys[:max_files]
    print(f"received {len(keys)} test vectors"
          + ("" if max_files is None else f" (limited by max_files={max_files})"))

    results_rows: List[Dict[str, Any]] = []
    states_by_processor: Dict[str, List[Dict[str, Any]]] = {p.name: [] for p in processors}
    saved_result_paths: List[str] = []
    saved_state_paths: Dict[str, List[str]] = {p.name: [] for p in processors}
    flush_idx = 0

    print_mismatched = bool(debug_params.get("print_mismatched", False))
    debug_all = bool(debug_params.get("debug_all", False))
    rain_min_thr = debug_params.get(
        "rain_drop_min_thr", params_global.get("rain_drop_min_thr")
    )
    log_memory = bool(debug_params.get("log_memory", False))
    device_batch = bool(debug_params.get("device_batch", True)) and all(
        hasattr(p, "run_batch") for p in processors
    )

    total_batches = (len(keys) + batch_size - 1) // batch_size if batch_size > 0 else 1

    for batch_idx, start in enumerate(range(0, len(keys), batch_size), start=1):
        batch_keys = keys[start : start + batch_size]
        print(f"Processing batch {batch_idx} of ~{total_batches}")

        dir_content = get_input_data_fn(
            batch_keys, InputType, Fs, check_duration, localStatus, local_cache,
            read_size=None, bytes_per_sample=2, **get_input_data_kwargs,
        )

        if device_batch:
            batch_outputs = _run_batch_device(
                dir_content=dir_content, processors=processors,
                params_global=params_global,
                params_by_processor=params_by_processor,
                required_samples=required_samples, rain_min_thr=rain_min_thr,
            )
        else:
            batch_outputs = []
            for fk, meta in dir_content.items():
                item = _process_single_file(
                    file_key=fk, meta=meta, processors=processors,
                    params_global=params_global,
                    params_by_processor=params_by_processor,
                    required_samples=required_samples, rain_min_thr=rain_min_thr,
                )
                if item is not None:
                    batch_outputs.append(item)

        for item in batch_outputs:
            row = item["row"]
            if ("rain__mismatch" in row
                    and ((print_mismatched and row["rain__mismatch"]) or debug_all)):
                rd = row.get("rain__rain_drop_count", row.get("rain__rain_drops"))
                print(
                    f"[mismatch] {row['file_key']}  actual={row.get('rain_actual')}  "
                    f"predicted={row.get('rain__predicted')}  rain_drops={rd}"
                )
            results_rows.append(row)
            for pn, st in item["states"].items():
                states_by_processor[pn].append(st)

        if log_memory:
            _log_memory_usage(prefix=f"[batch {batch_idx}]")

        if (save_dir_path is not None and max_batch_save > 0
                and len(results_rows) >= max_batch_save):
            flush_idx += 1
            rp, sp = flush_saved_batches(
                results_rows=results_rows,
                states_by_processor=states_by_processor,
                save_dir=save_dir_path, save_prefix=batch_save_prefix,
                flush_idx=flush_idx,
            )
            saved_result_paths.extend(rp)
            for name, paths in sp.items():
                saved_state_paths[name].extend(paths)
            results_rows.clear()
            for rows in states_by_processor.values():
                rows.clear()
            gc.collect()

        del dir_content
        gc.collect()

    has_pending_state = any(rows for rows in states_by_processor.values())
    if save_dir_path is not None and (results_rows or has_pending_state):
        flush_idx += 1
        rp, sp = flush_saved_batches(
            results_rows=results_rows, states_by_processor=states_by_processor,
            save_dir=save_dir_path, save_prefix=batch_save_prefix,
            flush_idx=flush_idx,
        )
        saved_result_paths.extend(rp)
        for name, paths in sp.items():
            saved_state_paths[name].extend(paths)

    results_df = pd.DataFrame(results_rows)
    if not results_df.empty:
        results_df = results_df.sort_values("file_key").reset_index(drop=True)
    results_df.attrs["saved_parquet_files"] = saved_result_paths

    states_df_by_proc: Dict[str, pd.DataFrame] = {}
    for name, rows in states_by_processor.items():
        if rows:
            df = pd.DataFrame(rows).sort_values("file_key").reset_index(drop=True)
        else:
            df = pd.DataFrame()
        df.attrs["saved_parquet_files"] = saved_state_paths.get(name, [])
        states_df_by_proc[name] = df

    wall = time.perf_counter() - _wall_t0
    n_files = len(keys)
    fps = (n_files / wall) if wall > 0 else None
    for df in [results_df, *states_df_by_proc.values()]:
        df.attrs["wall_time_sec"] = wall
        df.attrs["num_files_processed_total"] = n_files
        df.attrs["files_per_sec_total"] = fps
    print(f"Total wall time: {wall:.3f} s")
    print(f"Total files processed: {n_files}")
    if fps is not None:
        print(f"Throughput: {fps:.3f} files/s")
    return results_df, states_df_by_proc


process_audio_batches = process_audio_batches_v2
