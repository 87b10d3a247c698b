"""Inference server: micro-batched, bucketed checkpoint serving on the card.

Port of ``cross_attention_vit_tpu/drivers/serve.py``:

  * **Static batch buckets** (default 1/2/4/8): requests pad up to the
    nearest bucket, so the card only ever sees a few batch shapes.  PyTorch
    runs eagerly, so there is nothing to compile per bucket and the JAX
    server's persistent compile-cache flag (``--jit-cache``) does not apply.
  * **Micro-batching**: one dispatcher thread drains queued requests up to
    the largest bucket per step (waiting ``max_wait_ms`` for stragglers).
  * **Backpressure**: admission is bounded in volumes; beyond the bound a
    request is shed with ``Overloaded`` (HTTP 503 + Retry-After).
  * **Transfers**: each bucket has a pinned host staging buffer; the batch is
    copied host→device from it, then the forward runs under
    ``torch.inference_mode()``; the D2H copy of the logits is the sync.
    /stats splits transfer ms from device ms.

The checkpoint is the JAX package's npz layout with its config JSON beside it
(``train/checkpoint.py``); ``gelu_approx`` and the dtypes saved with the run
rebuild the model exactly.  Both live families are served, ModelCross
(``model="cross"``) and ModelVIT (``model="vit"``), in float or quantized:
``quantize="int8"`` runs the FFN and head GEMMs w8a8, ``"int8+attn"`` also
the self-attention projections, with the attention itself on the public
``flash_attention`` (``models/quantize.py``).  A MoE checkpoint (its config
carries ``moe_experts``) is served whole on one card, the router and experts
in f32 (they are not quantized, as in JAX); a ``seq_parallel`` config runs
the dense attention, having no seq mesh.

Sharded serving (``mesh``, any ``parallel.make_mesh`` mesh; JAX :121-134,
which places the parameters by ``shard_params(params, mesh)`` and sets no
ambient seq or pipeline mesh).  The JAX server is one process over many
chips; the port's is one process per card, every rank building the same
server.  Rank 0 runs HTTP and the dispatcher, and sends each padded bucket
batch to every rank (a broadcast over the world); each rank runs its part,
its data coordinate's rows on its 'model' slices of the heads and MLP
columns (``parallel.tensor``'s split; int8 layers stay whole, as JAX's
rules leave int8 leaves whole) and, for a MoE checkpoint over an 'expert'
axis, on its E/P experts (``parallel.moe.shard_experts``; the forward runs
over the expert mesh, routing the bucket's global batch as JAX's does), and
the logits come back to rank 0 (``parallel.gather_rows``).  As in JAX, the
'seq' and 'pipe' axes split nothing here: their ranks run their data
coordinate's rows alike, with the dense attention and the serial schedule
(JAX's server fails on a stacked ModelVIT over 'pipe' × 'model', whose TP
spec it does not shift past the depth axis; the port serves it).  The other
ranks run ``run_worker``, which returns when rank 0 stops.  Buckets that
the data axis does not divide raise ValueError up front.

Endpoints:
  GET  /healthz           — model family, param count, buckets, config dims
  GET  /stats             — served counts, batch-size histogram, latency ms
  POST /predict           — body: .npy bytes, (M,1,D,H,W) or (B,M,1,D,H,W)
                            float; returns JSON logits + class-1 probability
  POST /predict_subject   — {"id": "UCSF-PDGM-0004"} JSON: full NIfTI
                            pipeline (decode → pad/crop → forward) for a
                            subject directory under --data

CLI:
    python -m cross_attention_vit_tpu_torch.drivers.serve \\
        --checkpoint runs/checkpoints/cross/epoch=..npz --port 8000 \\
        --data /path/to/ucsf-data --img-types DWI SWI ASL [--model vit] \\
        [--quantize {int8,int8+attn}]
    torchrun --nproc-per-node 4 -m cross_attention_vit_tpu_torch.drivers.serve \\
        --checkpoint ... --mesh data=2,model=2
"""

from __future__ import annotations

import io
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..configs import get_mgmt_config, get_mgmt_cross_config, modify_config
from ..models.convert import load_jax_params, params_from_flat
from ..models.model_cross import ModelCross
from ..models.model_vit import ModelVIT
from ..models.quantize import count_quantized, quantize_for_inference
from ..parallel.mesh import axis_size, make_mesh, multihost_init
from ..parallel.moe import active_expert_mesh, set_expert_mesh, shard_experts
from ..parallel.sharding import gather_rows, shard_batch
from ..parallel.tensor import shard_tensor_parallel
from ..train.checkpoint import load_config_for, restore_flat
from ..utils.device import resolve_device

_FAMILIES = {"cross": (ModelCross, get_mgmt_cross_config),
             "vit": (ModelVIT, get_mgmt_config)}
_QUANTIZE_MODES = ("int8", "int8+attn")
_STOP, _BATCH = 0, 1        # the header rank 0 broadcasts before each batch


class Overloaded(RuntimeError):
    """Request shed: the bounded inference queue is full.  Maps to HTTP 503
    + Retry-After."""

    def __init__(self, pending: int, limit: int, retry_after_s: float):
        super().__init__(f"queue full ({pending}/{limit} volumes pending)")
        self.retry_after_s = retry_after_s


class _Request:
    __slots__ = ("vols", "event", "result", "error", "t_enqueue")

    def __init__(self, vols: np.ndarray):
        self.vols = vols            # (b, M, 1, D, H, W)
        self.event = threading.Event()
        self.result = None          # (b, num_classes) logits
        self.error: str | None = None
        self.t_enqueue = time.monotonic()


class InferenceServer:
    """Checkpoint → ModelCross or ModelVIT on ``device`` → micro-batching
    dispatcher."""

    def __init__(self, checkpoint: str | Path, model: str = "cross",
                 img_types=("DWI", "SWI", "ASL"), data_folder: str | None = None,
                 buckets=(1, 2, 4, 8), max_wait_ms: float = 5.0,
                 config_overrides=None, quantize: str | None = None,
                 mesh=None, max_queue_volumes: int = 64,
                 device: str | torch.device = "cuda"):
        if model not in _FAMILIES:
            raise ValueError(f"unknown model family {model!r}: expected one of "
                             f"{sorted(_FAMILIES)}")
        model_cls, factory = _FAMILIES[model]
        if quantize and quantize not in _QUANTIZE_MODES:
            raise ValueError(f"unknown quantize mode {quantize!r}: expected one of "
                             f"{_QUANTIZE_MODES}")
        if mesh is not None:
            if not isinstance(mesh, DeviceMesh):
                raise TypeError(f"mesh must be a parallel.make_mesh DeviceMesh, got "
                                f"{type(mesh).__name__}")
            data = axis_size(mesh, "data")
            bad = [b for b in buckets if b % data]
            if bad:
                raise ValueError(f"buckets {bad} not divisible by the mesh data axis ({data})")
        self.mesh = mesh
        self.rank = dist.get_rank() if mesh is not None else 0
        self.device = resolve_device(device)
        cfg = load_config_for(checkpoint)
        if cfg is None:
            cfg = factory()
            modify_config(cfg, dict(
                num_modalities=len(img_types), dropout=0.0, lr=1e-4,
                weight_decay=0.0, label_smoothing=0.0, attn_order={},
                img_aug=False, optim_params={"T_max": 1, "eta_min": 0}))
        if config_overrides:
            modify_config(cfg, config_overrides)
        modify_config(cfg, {"img_aug": False})
        self.cfg = cfg
        self.model_name = model
        self.img_types = tuple(img_types)
        self.data_folder = data_folder
        self.buckets = tuple(sorted(buckets))
        self.max_wait_s = max_wait_ms / 1e3

        self.model = model_cls(cfg, device=self.device)
        params = params_from_flat(restore_flat(checkpoint))
        load_jax_params(self.model, params)
        self.quantize = quantize or None
        self.quantized_kernels = 0
        if quantize:
            # from the checkpoint's f32 arrays, as the JAX server quantizes
            # its f32 params; the other GEMM weights stay cast once
            quantize_for_inference(self.model, attn=quantize == "int8+attn", source=params)
            self.quantized_kernels = count_quantized(self.model)[0]
        del params
        self.model.eval()
        # every leaf, the int8 weights and their scales included (JAX counts
        # the leaves of its rewritten tree), before any split
        self.n_params = sum(t.numel() for t in self.model.state_dict().values())
        if mesh is not None:
            shard_experts(self.model, mesh)
            shard_tensor_parallel(self.model, mesh)
            # the batches travel where the group's backend can move them
            self._wire = torch.device("cpu") if dist.get_backend() == "gloo" else self.device
            self._workers_stopped = False
        self._staging: dict[tuple, torch.Tensor] = {}   # pinned H2D buffers

        self.max_queue_volumes = int(max_queue_volumes)
        self._pending_volumes = 0
        self._pending_lock = threading.Lock()
        self._queue: queue.Queue[_Request] = queue.Queue()
        self._stats_lock = threading.Lock()
        self.stats = {"requests": 0, "volumes": 0, "batches": {},
                      "latency_ms": [], "shed_requests": 0,
                      "shed_volumes": 0, "transfer_ms": [], "device_ms": []}
        self._stop = threading.Event()
        self._dispatcher = threading.Thread(target=self._dispatch_loop,
                                            daemon=True)

    # -- lifecycle ---------------------------------------------------------
    def warmup(self) -> None:
        """Run every bucket once before accepting traffic (allocates the
        staging buffers and the caching allocator's blocks, loads the
        kernel library)."""
        m = self.cfg.num_modalities
        for b in self.buckets:
            x = np.zeros((b, m, 1, *self.cfg.img_size), np.float32)
            self._run_padded(x, b)

    def start(self) -> None:
        self._dispatcher.start()

    def stop(self) -> None:
        self._stop.set()
        if self._dispatcher.is_alive():
            # over a mesh the dispatcher issues every collective of rank 0,
            # the STOP header included: wait for it to leave its loop
            self._dispatcher.join(timeout=None if self.mesh is not None else 5)
        elif self.mesh is not None and self.rank == 0:
            self._stop_workers()      # never started: no other thread sends

    def run_worker(self) -> None:
        """A sharded server's loop on every rank but 0: run its part of each
        batch rank 0 sends; return when rank 0 stops."""
        if self.mesh is None or self.rank == 0:
            raise RuntimeError("run_worker is the loop of the ranks other than 0 of a "
                               "sharded server")
        while True:
            code, b = self._broadcast_header()
            if code == _STOP:
                return
            self._sharded_forward(self._broadcast_batch(None, b))

    # -- request path ------------------------------------------------------
    def predict(self, vols: np.ndarray, timeout: float = 120.0) -> np.ndarray:
        """vols: (b, M, 1, D, H, W) float32 → (b, num_classes) logits."""
        if self.rank != 0:
            raise RuntimeError(f"rank {self.rank} of a sharded server takes no requests: "
                               "rank 0 serves them, the others run run_worker")
        want = (self.cfg.num_modalities, 1, *self.cfg.img_size)
        if vols.ndim == len(want) + 1:
            if tuple(vols.shape[1:]) != want:
                raise ValueError(f"volume shape {vols.shape[1:]} != {want}")
        else:
            raise ValueError(f"expected (b, {', '.join(map(str, want))}), "
                             f"got {vols.shape}")
        b = vols.shape[0]
        with self._pending_lock:
            if self._pending_volumes + b > self.max_queue_volumes:
                pending = self._pending_volumes
                with self._stats_lock:
                    self.stats["shed_requests"] += 1
                    self.stats["shed_volumes"] += b
                # a drained max-bucket step frees buckets[-1] slots; advise
                # retrying after roughly the backlog's drain time
                steps = max(1, pending // self.buckets[-1])
                raise Overloaded(pending, self.max_queue_volumes,
                                 retry_after_s=max(0.05, 0.1 * steps))
            self._pending_volumes += b
        req = _Request(np.ascontiguousarray(vols, np.float32))
        self._queue.put(req)
        if not req.event.wait(timeout):
            raise TimeoutError("inference timed out")
        if req.error:
            raise RuntimeError(req.error)
        return req.result

    def predict_subject(self, case_id: str) -> np.ndarray:
        """Full NIfTI pipeline for one subject under `data_folder`."""
        if self.data_folder is None:
            raise RuntimeError("server started without --data")
        from ..data.nifti import read_volume_cropped, volume_path

        vols = [read_volume_cropped(
                    volume_path(self.data_folder, case_id, t),
                    tuple(self.cfg.img_size), fill=-1.0)[None]
                for t in self.img_types]
        return self.predict(np.stack(vols)[None])[0]

    # -- dispatcher --------------------------------------------------------
    def _dispatch_loop(self) -> None:
        max_b = self.buckets[-1]
        try:
            while not self._stop.is_set():
                try:
                    first = self._queue.get(timeout=0.1)
                except queue.Empty:
                    continue
                batch = [first]
                n = first.vols.shape[0]
                deadline = time.monotonic() + self.max_wait_s
                while n < max_b:
                    remain = deadline - time.monotonic()
                    if remain <= 0:
                        break
                    try:
                        nxt = self._queue.get(timeout=remain)
                    except queue.Empty:
                        break
                    batch.append(nxt)
                    n += nxt.vols.shape[0]
                self._run_batch(batch, n)
        finally:
            self._fail_queued("server stopped")
            if self.mesh is not None:
                self._stop_workers()

    def _fail_queued(self, error: str) -> None:
        """Answer every request still queued with ``error``."""
        while True:
            try:
                r = self._queue.get_nowait()
            except queue.Empty:
                return
            with self._pending_lock:
                self._pending_volumes -= r.vols.shape[0]
            r.error = error
            r.event.set()

    def _run_batch(self, batch: list[_Request], n: int) -> None:
        bucket = next((b for b in self.buckets if b >= n), None)
        try:
            vols = np.concatenate([r.vols for r in batch])
            if bucket is None:  # oversized burst: split at the largest bucket
                logits = np.concatenate(
                    [self._run_padded(vols[i:i + self.buckets[-1]])
                     for i in range(0, n, self.buckets[-1])])
            else:
                logits = self._run_padded(vols, bucket)
            off = 0
            now = time.monotonic()
            with self._stats_lock:
                self.stats["requests"] += len(batch)
                self.stats["volumes"] += n
                self.stats["batches"][n] = self.stats["batches"].get(n, 0) + 1
                self.stats["latency_ms"].extend(
                    (now - r.t_enqueue) * 1e3 for r in batch)
                del self.stats["latency_ms"][:-1000]  # keep a bounded window
            for r in batch:
                b = r.vols.shape[0]
                r.result = logits[off:off + b]
                off += b
                r.event.set()
        except Exception as e:  # surface to every waiter, keep serving
            for r in batch:
                r.error = f"{type(e).__name__}: {e}"
                r.event.set()
            if self.mesh is not None:
                # the ranks' collectives are out of step: serve no more and
                # send nothing more (the group's timeout ends the others' wait)
                self._workers_stopped = True
                self._stop.set()
        finally:
            with self._pending_lock:
                self._pending_volumes -= n

    def _to_device(self, vols: np.ndarray) -> torch.Tensor:
        """H2D from a pinned staging buffer, synchronised so the transfer time
        is its own.  Only the dispatcher thread (or warmup, before it starts)
        calls this, so one buffer per shape is never written while in use."""
        if self.device.type != "cuda":
            return torch.from_numpy(vols).to(self.device)
        staging = self._staging.get(vols.shape)
        if staging is None:
            staging = torch.empty(vols.shape, dtype=torch.float32, pin_memory=True)
            self._staging[vols.shape] = staging
        staging.numpy()[...] = vols
        dev = staging.to(self.device, non_blocking=True)
        torch.cuda.current_stream(self.device).synchronize()
        return dev

    def _run_padded(self, vols: np.ndarray, bucket: int | None = None) -> np.ndarray:
        n = vols.shape[0]
        if bucket is None:
            bucket = next(b for b in self.buckets if b >= n)
        if n < bucket:
            pad = np.zeros((bucket - n, *vols.shape[1:]), vols.dtype)
            vols = np.concatenate([vols, pad])
        t0 = time.monotonic()
        if self.mesh is not None:
            self._broadcast_header(_BATCH, vols.shape[0])
            batch = self._broadcast_batch(vols, vols.shape[0])
            t1 = time.monotonic()
            out = self._sharded_forward(batch)[:n]
        else:
            dev = self._to_device(vols)
            t1 = time.monotonic()
            with torch.inference_mode():
                logits = self.model(dev)
            out = logits.cpu().numpy()[:n]     # the D2H copy waits for the forward
        t2 = time.monotonic()
        with self._stats_lock:
            self.stats["transfer_ms"].append((t1 - t0) * 1e3)
            self.stats["device_ms"].append((t2 - t1) * 1e3)
            del self.stats["transfer_ms"][:-1000]
            del self.stats["device_ms"][:-1000]
        return out

    # -- sharded serving -----------------------------------------------------
    def _stop_workers(self) -> None:
        """Send the STOP header once, from the one thread issuing rank 0's
        collectives."""
        if not self._workers_stopped:
            self._workers_stopped = True
            self._broadcast_header(_STOP, 0)

    def _broadcast_header(self, code: int = _STOP, b: int = 0) -> tuple[int, int]:
        """Rank 0's (code, batch size), on every rank."""
        header = torch.tensor([code, b], dtype=torch.int64, device=self._wire)
        dist.broadcast(header, src=0)
        return int(header[0]), int(header[1])

    def _broadcast_batch(self, vols: np.ndarray | None, b: int) -> torch.Tensor:
        """Rank 0's padded bucket batch (b, M, 1, D, H, W), on every rank."""
        shape = (b, self.cfg.num_modalities, 1, *self.cfg.img_size)
        if vols is None:
            batch = torch.empty(shape, dtype=torch.float32, device=self._wire)
        else:
            batch = torch.from_numpy(np.ascontiguousarray(vols, np.float32)).to(self._wire)
        dist.broadcast(batch, src=0)
        return batch

    def _sharded_forward(self, batch: torch.Tensor) -> np.ndarray:
        """This rank's data coordinate's rows of the batch through its part
        of the model; every coordinate's logits, in data order."""
        rows, = shard_batch((batch,), self.mesh)
        before = active_expert_mesh()
        if axis_size(self.mesh, "expert") > 1:      # the MoE sites' experts are split
            set_expert_mesh(self.mesh)
        try:
            with torch.inference_mode():
                logits = self.model(rows.to(self.device))
                return gather_rows(logits.float(), self.mesh).cpu().numpy()
        finally:
            set_expert_mesh(before)

    # -- introspection -----------------------------------------------------
    def health(self) -> dict:
        return {"status": "ok", "model": self.model_name,
                "params": self.n_params, "buckets": list(self.buckets),
                "quantize": self.quantize, "quantized_kernels": self.quantized_kernels,
                "device": str(self.device),
                "mesh": (None if self.mesh is None else
                         dict(zip(self.mesh.mesh_dim_names, self.mesh.mesh.shape))),
                "num_modalities": int(self.cfg.num_modalities),
                "img_size": list(self.cfg.img_size),
                "img_types": list(self.img_types)}

    def stats_view(self) -> dict:
        def quantiles(xs):
            xs = sorted(xs)
            pick = (lambda p: xs[min(len(xs) - 1, int(p * len(xs)))]
                    if xs else None)
            return {"p50": pick(0.5), "p90": pick(0.9), "p99": pick(0.99)}

        with self._stats_lock, self._pending_lock:
            return {"requests": self.stats["requests"],
                    "volumes": self.stats["volumes"],
                    "batch_histogram": dict(self.stats["batches"]),
                    "latency_ms": quantiles(self.stats["latency_ms"]),
                    "transfer_ms": quantiles(self.stats["transfer_ms"]),
                    "device_ms": quantiles(self.stats["device_ms"]),
                    "pending_volumes": self._pending_volumes,
                    "queue_limit_volumes": self.max_queue_volumes,
                    "shed_requests": self.stats["shed_requests"],
                    "shed_volumes": self.stats["shed_volumes"]}


def make_handler(server: InferenceServer):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet by default; /stats has the data
            pass

        def _reply(self, code: int, payload: dict,
                   extra_headers: dict | None = None) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in (extra_headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, server.health())
            elif self.path == "/stats":
                self._reply(200, server.stats_view())
            else:
                self._reply(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            length = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(length)
            try:
                if self.path == "/predict":
                    vols = np.load(io.BytesIO(body), allow_pickle=False)
                    if vols.ndim == 5:  # single item: add the batch axis
                        vols = vols[None]
                    logits = server.predict(vols)
                elif self.path == "/predict_subject":
                    case_id = json.loads(body)["id"]
                    logits = server.predict_subject(case_id)[None]
                else:
                    return self._reply(404, {"error": f"no route {self.path}"})
            except Overloaded as e:
                # shed: bounded queue is full — the client should back off
                return self._reply(
                    503, {"error": str(e),
                          "retry_after_s": round(e.retry_after_s, 3)},
                    extra_headers={"Retry-After":
                                   f"{max(1, round(e.retry_after_s))}"})
            except (ValueError, KeyError, RuntimeError, TimeoutError) as e:
                return self._reply(400, {"error": str(e)})
            e = np.exp(logits - logits.max(1, keepdims=True))
            probs = e / e.sum(1, keepdims=True)
            self._reply(200, {"logits": logits.tolist(),
                              "prob_class1": probs[:, 1].tolist()})

    return Handler


def serve(server: InferenceServer, host: str = "127.0.0.1",
          port: int = 8000) -> ThreadingHTTPServer:
    """Bind, warm up every bucket, start the dispatcher; returns the bound
    httpd (caller runs serve_forever, or uses it as a handle in tests)."""
    httpd = ThreadingHTTPServer((host, port), make_handler(server))
    server.warmup()
    server.start()
    return httpd


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="serve a ModelCross or ModelVIT checkpoint")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--model", choices=sorted(_FAMILIES), default="cross",
                   help="model family of the checkpoint")
    p.add_argument("--img-types", nargs="+", default=["DWI", "SWI", "ASL"])
    p.add_argument("--data", default=None,
                   help="NIfTI root for /predict_subject")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--buckets", type=int, nargs="+", default=[1, 2, 4, 8])
    p.add_argument("--max-wait-ms", type=float, default=5.0)
    p.add_argument("--max-queue-volumes", type=int, default=64,
                   help="admission bound: volumes allowed in the queue; "
                        "beyond it requests shed with 503 + Retry-After")
    p.add_argument("--quantize", choices=_QUANTIZE_MODES, default=None,
                   help="int8 w8a8 FFN and head GEMMs (inference only; ops/quant.py); "
                        "int8+attn also quantizes the self-attention qkv/out projections "
                        "(the attention stays float, on its kernels)")
    p.add_argument("--mesh", default="",
                   help="e.g. 'data=2,model=2' or 'data=1,expert=2,model=2' for sharded "
                        "serving (axes pipe, data, expert, seq, model), one process per device "
                        "under torchrun (buckets must divide the data axis); rank 0 serves "
                        "HTTP")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain PyTorch path")
    args = p.parse_args(argv)

    mesh = None
    if args.mesh:
        spec = {k: int(v) for k, v in (kv.split("=") for kv in args.mesh.split(","))}
        multihost_init(device=args.device)     # torchrun's environment
        mesh = make_mesh(spec.get("data", -1), spec.get("model", 1), pipe=spec.get("pipe", 1),
                         seq=spec.get("seq", 1), expert=spec.get("expert", 1))
    server = InferenceServer(args.checkpoint, args.model, img_types=tuple(args.img_types),
                             data_folder=args.data, buckets=args.buckets,
                             max_wait_ms=args.max_wait_ms, quantize=args.quantize,
                             mesh=mesh, max_queue_volumes=args.max_queue_volumes,
                             device=args.device)
    if server.rank != 0:
        server.run_worker()
        return
    httpd = serve(server, args.host, args.port)
    print(f"serving {args.model} ({server.n_params / 1e6:.1f}M params) on "
          f"{server.device} at http://{args.host}:{args.port}  buckets={args.buckets}")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        server.stop()


if __name__ == "__main__":
    main()
