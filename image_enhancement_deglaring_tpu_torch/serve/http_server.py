"""HTTP serving API — request/response compatible with the reference
FastAPI app (reference: api/app.py):

- ``GET /ping``  -> 200 ``{"message":"pong"}``            (api/app.py:104-107)
- ``POST /infer`` multipart field "image" -> 200
  ``{"image": "<base64 PNG>"}``                            (api/app.py:109-213)
- missing image -> 400 ``{"detail":"No image provided"}``; any processing
  error -> 500 ``{"detail": "..."}`` (FastAPI HTTPException body shape)

Additions beyond the reference API: ``GET /stats`` (JSON serving
observability), ``GET /metrics`` (the same numbers in Prometheus text
exposition format for k8s scraping), optional ``POST /reload``
(zero-downtime weight swap), and per-request ``?mode=tile|resize``.
``GET /openapi.json`` and ``GET /docs`` match the reference's FastAPI
auto-docs (self-contained HTML — no CDN assets).

The port's counterpart of ``image_enhancement_deglaring_tpu.serve.
http_server``: the same stdlib asyncio HTTP/1.1 server with hand-rolled
multipart parsing, its framing rules, limits, routes, SIGTERM drain and
host phase timings, line for line. Only ``_infer`` differs: the machine
with the card has no PIL, so image decode, the luma conversion and the
LANCZOS resizes run on the port's own host path (``serve.imaging``),
equal to PIL's bit for bit (reference: api/app.py:150,203), and the
response PNG is written by the port's codec; JPEG uploads are decoded by
the port's own decoder (``data.jpeg``), as PIL decodes them.
Normalization, the U-Net forward, clipping and the uint8 conversion run
on the card inside the engine (``serve.engine``).

Logging mirrors the reference: named logger, 10MB x 5 rotating file +
console handlers, per-request IDs (api/app.py:16-42,112).
"""

from __future__ import annotations

import asyncio
import base64
import json
import logging
import os
# NOT an alias of builtin TimeoutError until Python 3.11; pyproject's floor
# is 3.10, where engine-future timeouts would otherwise escape the handlers
from concurrent.futures import TimeoutError as FuturesTimeoutError
from logging.handlers import RotatingFileHandler

import numpy as np


def make_api_logger(log_dir: str | None = None, name: str = "image_enhancement_api",
                    filename: str = "api.log"):
    """``filename``: per-process log file name — RotatingFileHandler's
    rename-based rotation is unsafe across processes, so multi-worker
    serving gives each process its own file (serve/ipc.py)."""
    logger = logging.getLogger(name)
    if logger.handlers:
        return logger
    logger.setLevel(logging.DEBUG)
    log_dir = log_dir or os.path.join(os.getcwd(), "logs")
    os.makedirs(log_dir, exist_ok=True)
    fh = RotatingFileHandler(os.path.join(log_dir, filename),
                             maxBytes=10485760, backupCount=5)
    fh.setLevel(logging.DEBUG)
    fh.setFormatter(logging.Formatter("%(asctime)s - %(name)s - %(levelname)s - %(message)s"))
    ch = logging.StreamHandler()
    ch.setLevel(logging.INFO)
    ch.setFormatter(logging.Formatter("%(levelname)s: %(message)s"))
    logger.addHandler(fh)
    logger.addHandler(ch)
    return logger


def _disposition_params(header_value: str) -> dict[str, str]:
    """Parse `form-data; name="a"; filename="x;y.png"` — quote-aware, so a
    quoted value may contain ';' and escaped quotes."""
    params: dict[str, str] = {}
    i = 0
    n = len(header_value)
    while i < n:
        semi = header_value.find(";", i)
        eq = header_value.find("=", i)
        if eq == -1 or (semi != -1 and semi < eq):
            i = (semi + 1) if semi != -1 else n
            continue
        key = header_value[i:eq].strip().lower()
        j = eq + 1
        while j < n and header_value[j] in " \t":
            j += 1
        if j < n and header_value[j] == '"':
            j += 1
            val = []
            while j < n and header_value[j] != '"':
                if header_value[j] == "\\" and j + 1 < n:
                    j += 1
                val.append(header_value[j])
                j += 1
            params[key] = "".join(val)
            i = header_value.find(";", j)
            i = (i + 1) if i != -1 else n
        else:
            end = header_value.find(";", j)
            end = end if end != -1 else n
            params[key] = header_value[j:end].strip()
            i = end + 1
    return params


def parse_multipart(body: bytes, content_type: str) -> dict[str, bytes]:
    """Extract form fields from a multipart/form-data body.

    RFC 7578 framing: each part's payload is the bytes between its blank
    header line and the CRLF that *precedes* the next boundary delimiter —
    exactly one CRLF frame is removed, so binary payloads that legitimately
    end in 0x0D/0x0A round-trip unchanged. Quoted boundaries and quoted
    disposition params (name/filename with ';' inside) are handled.
    """
    boundary = _disposition_params(content_type).get("boundary")
    if not boundary:
        return {}
    delim = b"--" + boundary.encode()
    fields: dict[str, bytes] = {}

    # first boundary: at body start, or preceded by CRLF after a preamble
    if body.startswith(delim):
        pos = len(delim)
    else:
        start = body.find(b"\r\n" + delim)
        if start < 0:
            return {}
        pos = start + 2 + len(delim)

    while True:
        if body[pos : pos + 2] == b"--":  # closing delimiter
            break
        # exactly one CRLF (tolerate bare LF) terminates the boundary line
        if body[pos : pos + 2] == b"\r\n":
            pos += 2
        elif body[pos : pos + 1] == b"\n":
            pos += 1
        nxt = body.find(b"\r\n" + delim, pos)
        if nxt < 0:
            part, end = body[pos:], -1
        else:
            part, end = body[pos:nxt], nxt + 2 + len(delim)
        header_blob, sep, data = part.partition(b"\r\n\r\n")
        if not sep:  # no header/body separator: treat everything as headers
            header_blob, data = part, b""
        name = None
        for line in header_blob.split(b"\r\n"):
            if line.lower().startswith(b"content-disposition"):
                _, _, value = line.decode(errors="replace").partition(":")
                name = _disposition_params(value).get("name")
        if name is not None:
            fields[name] = data
        if end < 0:
            break
        pos = end
    return fields


class DeglareServer:
    #: reject request bodies above this size (decompressed PNGs of huge
    #: documents still fit comfortably; protects the decode path)
    MAX_BODY_BYTES = 64 * 1024 * 1024
    #: per-connection read timeout
    READ_TIMEOUT_S = 30.0
    MAX_TRAILER_LINES = 256
    MAX_HEADER_LINES = 256

    #: zlib level for response PNGs. 1 encodes ~2x faster than zlib's
    #: default 6 at ~1.5x the bytes — the right trade for a serving path
    #: whose output is decoded once by the caller. (PNG bytes are not part
    #: of the reference contract; pixel values are, and they're identical.)
    PNG_COMPRESS_LEVEL = 1
    #: idle keep-alive wait before closing a persistent connection
    KEEPALIVE_TIMEOUT_S = 15.0
    #: bound on one request's engine wait — generous enough for a cold
    #: first dispatch (create_server's warmup builds the kernels first),
    #: small enough that a truly wedged device step cannot hold
    #: connections forever
    INFER_TIMEOUT_S = 300.0

    def __init__(self, engine, *, host: str = "0.0.0.0", port: int = 4000,
                 image_size: int = 512, mode: str = "resize",
                 tiler=None, log_dir: str | None = None,
                 allow_reload: bool = False, log_filename: str = "api.log",
                 model_info: dict | None = None):
        """Args:
            engine: InferenceEngine (512^2 path).
            mode: "resize" reproduces the reference API exactly (downsample
                any input to 512^2, upsample back); "tile" uses ``tiler``
                for true full-resolution inference.
            allow_reload: expose POST /reload (zero-downtime weight swap
                from a checkpoint path on the server's filesystem). Off by
                default — it lets callers point the server at local files.
        """
        self.engine = engine
        self.host = host
        self.port = port
        self.image_size = image_size
        self.mode = mode
        self.tiler = tiler
        self.allow_reload = allow_reload
        # what's deployed (artifact path, family, quantize, dtype) — merged
        # into /stats so operators can confirm which weights are live,
        # especially after a /reload. String values: the /metrics renderer
        # passes through numeric stats only, so these never become series.
        self.model_info = dict(model_info or {})
        self.logger = make_api_logger(log_dir, filename=log_filename)
        self._server: asyncio.AbstractServer | None = None
        # request-processing pool: asyncio's default executor is ~5 threads,
        # which caps concurrent requests (each blocks on the engine future
        # for a device round-trip) far below what the micro-batcher can
        # coalesce; threads waiting on futures don't hold the GIL
        from concurrent.futures import ThreadPoolExecutor

        self._executor = ThreadPoolExecutor(max_workers=64,
                                            thread_name_prefix="infer")
        # tile-mode device calls run on their own small pool with the same
        # bounded wait as the resize path (which is bounded by the engine
        # future's timeout): a wedged device call must not pin request
        # threads — at worst it strands these 4, never the 64 above, so
        # /stats and resize-mode /infer keep working through a device hang
        self._tile_executor = ThreadPoolExecutor(max_workers=4,
                                                 thread_name_prefix="tile")
        # host-side phase timing for /stats (rolling, last 1024 requests):
        # where a request's wall time goes — decode+luma+resize, engine
        # (queue + device), PNG encode — alongside the engine's own stats
        import threading as _threading
        from collections import deque as _deque

        self._phase_lock = _threading.Lock()
        self._phases = {k: _deque(maxlen=1024)
                        for k in ("decode_ms", "engine_ms", "encode_ms")}
        # SIGTERM drain flag: once set, still-open keep-alive connections get
        # 503 + Connection: close for NEW requests instead of being dropped
        # by a post-shutdown run_in_executor RuntimeError
        self._draining = False

    def _record_phases(self, decode_s: float, engine_s: float,
                       encode_s: float) -> None:
        with self._phase_lock:
            self._phases["decode_ms"].append(decode_s * 1e3)
            self._phases["engine_ms"].append(engine_s * 1e3)
            self._phases["encode_ms"].append(encode_s * 1e3)

    def host_phase_stats(self) -> dict:
        with self._phase_lock:
            snap = {k: list(v) for k, v in self._phases.items()}
        return {f"host_{k}_p50": (sorted(v)[len(v) // 2] if v else None)
                for k, v in snap.items()}

    # ------------------------------------------------------------ handlers
    def _ping(self):
        return 200, {"message": "pong"}

    def _infer(self, body: bytes, content_type: str, query: str = ""):
        from ..data.png import encode_png
        from .imaging import decode_image, resize_lanczos, to_luma

        request_id = base64.urlsafe_b64encode(os.urandom(6)).decode("ascii")
        log = self.logger
        # per-request mode override (?mode=tile|resize) — an addition beyond
        # the reference API, which always downsamples (reference:
        # api/app.py:150); the server default is self.mode
        mode = self.mode
        if query:
            from urllib.parse import parse_qs

            requested = parse_qs(query).get("mode", [mode])[0]
            if requested not in ("resize", "tile"):
                return 400, {"detail": f"Unknown mode '{requested}'"}
            if requested == "tile" and self.tiler is None:
                return 400, {"detail": "tile mode not enabled on this server"}
            mode = requested
        fields = parse_multipart(body, content_type)
        contents = fields.get("image")
        if contents is None or len(contents) == 0:
            log.warning(f"[{request_id}] No image provided")
            return 400, {"detail": "No image provided"}
        try:
            from time import monotonic as _mono

            t0 = _mono()
            img = decode_image(contents)
            original_size = (img.pixels.shape[1], img.pixels.shape[0])
            log.info(
                f"[{request_id}] Original image dimensions: "
                f"{original_size[0]}x{original_size[1]}, mode: {img.mode}"
            )
            # luminance by PIL's convert("L") rules for EVERY mode
            # (reference: api/app.py:140-146 for RGB/RGBA — identical
            # result; plus LA/palette/1-bit/16-bit, where a raw array
            # would 500 on odd shapes or silently feed palette indices or
            # wrapped values to the model)
            img_gray = to_luma(img.pixels, img.mode, img.palette)

            if mode == "tile" and self.tiler is not None:
                log.info(f"[{request_id}] Tiled full-resolution inference "
                         f"({self.tiler.num_tiles(*img_gray.shape)} tiles)")
                t1 = _mono()
                enhanced_u8 = self._tile_executor.submit(
                    self.tiler, img_gray.astype(np.uint8)).result(
                        timeout=self.INFER_TIMEOUT_S)
                t2 = _mono()
            else:
                # reference behavior: LANCZOS down to 512^2, infer, LANCZOS back
                # (api/app.py:150,203); the resizes are skipped when the
                # image is already at target size (identity, saves ~12ms of
                # host CPU per 512^2 request)
                s = self.image_size
                if img_gray.shape == (s, s):
                    resized = img_gray
                else:
                    resized = resize_lanczos(img_gray, (s, s))
                # submit() goes through the micro-batching queue so
                # concurrent requests coalesce into one device batch
                # bounded wait: if the engine dies mid-request the thread
                # must not block forever (futures error out on stop(), but a
                # wedged device step would otherwise hang the connection)
                t1 = _mono()
                enhanced_u8 = self.engine.submit(
                    resized.astype(np.uint8)).result(
                        timeout=self.INFER_TIMEOUT_S)
                t2 = _mono()
                if original_size != (s, s):
                    enhanced_u8 = resize_lanczos(enhanced_u8, original_size)

            png = encode_png(enhanced_u8, compress_level=self.PNG_COMPRESS_LEVEL)
            out = base64.b64encode(png).decode("utf-8")
            self._record_phases(t1 - t0, t2 - t1, _mono() - t2)
            log.info(f"[{request_id}] Successfully processed image")
            return 200, {"image": out}
        except Exception as e:
            import traceback

            log.error(f"[{request_id}] Error: {e}\n{traceback.format_exc()}")
            return 500, {"detail": str(e)}

    def _reload(self, body: bytes):
        """Zero-downtime weight swap (addition beyond the reference API):
        POST /reload {"model_path": "..."} loads a same-family checkpoint
        and atomically swaps the engine's (and tiler's) weights; in-flight
        batches finish on the old weights."""
        log = self.logger
        try:
            req = json.loads(body or b"{}")
            model_path = req.get("model_path")
            if not model_path or not os.path.exists(model_path):
                return 400, {"detail": f"model_path not found: {model_path!r}"}
            from ..modelio import detect_model_arch

            arch = req.get("model", "auto")
            if arch == "auto":
                arch = detect_model_arch(model_path)
            # a family other than the engine's, or another width, fails in
            # load_jax_params' name and shape checks
            from ..eval.harness import load_model_for_eval

            # the weights are read on the host; each backend copies them
            # into a copy of its own model on its device
            _, params = load_model_for_eval(model_path, model_arch=arch,
                                            device="cpu")
            self.engine.reload_params(params)
            if self.tiler is not None:
                self.tiler.reload_params(params)
            log.info(f"Reloaded weights from {model_path} (arch={arch})")
            self.model_info.update(model_path=model_path, model=arch)
            return 200, {"status": "reloaded", "model_path": model_path,
                         "model": arch}
        except ValueError as e:
            return 400, {"detail": str(e)}
        except Exception as e:
            import traceback

            log.error(f"Reload error: {e}\n{traceback.format_exc()}")
            return 500, {"detail": str(e)}

    # ------------------------------------------------------------ plumbing
    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        """Persistent-connection request loop (HTTP/1.1 keep-alive): serves
        requests until the client closes, sends `Connection: close`, or
        idles past KEEPALIVE_TIMEOUT_S — load generators and the frontend
        reuse sockets instead of paying a TCP handshake per request."""
        try:
            first = True
            while True:
                try:
                    request_line = await asyncio.wait_for(
                        reader.readline(),
                        timeout=self.READ_TIMEOUT_S if first
                        else self.KEEPALIVE_TIMEOUT_S,
                    )
                except ValueError:
                    # StreamReader.readline raises ValueError once a line
                    # exceeds its 64 KiB limit (e.g. a huge query string) —
                    # answer, don't drop with an unhandled traceback
                    await self._respond(writer, 414,
                                        {"detail": "Request line too long"},
                                        close=True)
                    return
                first = False
                if not request_line or request_line in (b"\r\n", b"\n"):
                    return
                try:
                    method, path, version = request_line.decode().split()
                except ValueError:
                    await self._respond(writer, 400, {"detail": "Bad request"},
                                        close=True)
                    return
                # Starlette (the reference's FastAPI) serves HEAD on every
                # GET route: same status/headers, no body — k8s probes and
                # load balancers rely on it. Decided here so that even
                # error responses (bad headers, oversize body, ...) honor
                # RFC 9110 §9.3.2 and carry no body on a HEAD request.
                head_only = method == "HEAD"
                if head_only:
                    method = "GET"

                # header section: count-capped and under ONE deadline, like
                # the body paths — a per-line timeout resets on every line,
                # letting a slow-loris client grow the dict without bound
                # and hold the connection through the SIGTERM drain
                headers: dict[str, str] = {}

                async def read_headers():
                    for _ in range(self.MAX_HEADER_LINES):
                        line = await reader.readline()
                        if line in (b"\r\n", b"\n", b""):
                            return True
                        k, _, v = line.decode(errors="replace").partition(":")
                        headers[k.strip().lower()] = v.strip()
                    return False

                try:
                    headers_ok = await asyncio.wait_for(
                        read_headers(), timeout=self.READ_TIMEOUT_S)
                except ValueError:
                    # a single header line above the StreamReader limit
                    await self._respond(
                        writer, 431,
                        {"detail": "Request header fields too large"},
                        close=True, head_only=head_only)
                    return
                if not headers_ok:
                    await self._respond(writer, 400,
                                        {"detail": "Too many headers"},
                                        close=True, head_only=head_only)
                    return

                conn = headers.get("connection", "").lower()
                keep_alive = (version.upper() != "HTTP/1.0" or conn == "keep-alive") \
                    and conn != "close"

                te = headers.get("transfer-encoding", "").lower()
                if "chunked" in te:
                    # streaming clients of unknown body length (curl -T,
                    # proxies, SDKs) — uvicorn accepts these transparently,
                    # so must this API (reference: api/app.py:221-222)
                    try:
                        # ONE deadline for the whole body, like the
                        # Content-Length path: per-read timeouts would reset
                        # on every chunk, letting a slow-loris client hold
                        # the connection (and the drain window) open forever
                        body = await asyncio.wait_for(
                            self._read_chunked(reader),
                            timeout=self.READ_TIMEOUT_S)
                    except ValueError:
                        await self._respond(writer, 400,
                                            {"detail": "Bad chunked encoding"},
                                            close=True, head_only=head_only)
                        return
                    if body is None:
                        # bound exceeded mid-stream; the rest is unread, so
                        # the connection cannot be kept in sync — close it
                        await self._respond(writer, 413,
                                            {"detail": "Request body too large"},
                                            close=True, head_only=head_only)
                        return
                elif te and te != "identity":
                    await self._respond(writer, 501,
                                        {"detail": f"transfer-encoding "
                                                   f"{te!r} not supported"},
                                        close=True, head_only=head_only)
                    return
                else:
                    try:
                        length = int(headers.get("content-length", "0") or 0)
                    except ValueError:
                        await self._respond(writer, 400,
                                            {"detail": "Bad Content-Length"},
                                            close=True, head_only=head_only)
                        return
                    if length < 0:
                        await self._respond(writer, 400,
                                            {"detail": "Bad Content-Length"},
                                            close=True, head_only=head_only)
                        return
                    if length > self.MAX_BODY_BYTES:
                        await self._respond(writer, 413,
                                            {"detail": "Request body too large"},
                                            close=True, head_only=head_only)
                        return
                    body = b""
                    if length:
                        body = await asyncio.wait_for(
                            reader.readexactly(length),
                            timeout=self.READ_TIMEOUT_S
                        )

                route, _, query = path.partition("?")
                raw = None  # (body_bytes, content_type) for non-JSON routes
                extra_headers = None  # e.g. Allow on 405
                if self._draining and not (method == "GET" and route == "/ping"):
                    # drain window: answer (don't drop) late pipelined
                    # requests on surviving keep-alive connections, and tell
                    # the client to reconnect elsewhere
                    await self._respond(writer, 503,
                                        {"detail": "Server is shutting down"},
                                        close=True, head_only=head_only)
                    return
                try:
                    if method == "GET" and route == "/ping":
                        status, payload = self._ping()
                    elif method == "GET" and route == "/stats":
                        # serving observability (addition beyond the reference
                        # API); via the executor — with multi-process workers
                        # stats() is a blocking IPC round-trip that must not
                        # stall the event loop's other connections
                        loop = asyncio.get_running_loop()
                        try:
                            stats = await loop.run_in_executor(
                                self._executor, self.engine.stats)
                            stats.update(self.host_phase_stats())
                            stats.update(self.model_info)
                            status, payload = 200, stats
                        except (TimeoutError, FuturesTimeoutError,
                                RuntimeError) as e:
                            if self._draining:
                                raise  # handled by the drain-race catch
                            # a dead engine must read as a 500, not a
                            # dropped connection monitoring mistakes for a
                            # network flake
                            status, payload = 500, {"detail": str(e)}
                    elif method == "GET" and route == "/metrics":
                        # Prometheus scrape target: the /stats numbers in
                        # text exposition format (same executor rationale
                        # as /stats — the IPC stats round-trip must not
                        # stall the event loop)
                        from .metrics import (
                            PROMETHEUS_CONTENT_TYPE,
                            prometheus_text,
                        )

                        loop = asyncio.get_running_loop()
                        try:
                            stats = await loop.run_in_executor(
                                self._executor, self.engine.stats)
                            stats.update(self.host_phase_stats())
                            status = 200
                            raw = (prometheus_text(
                                stats, worker=str(os.getpid())).encode(),
                                PROMETHEUS_CONTENT_TYPE)
                        except (TimeoutError, FuturesTimeoutError,
                                RuntimeError) as e:
                            if self._draining:
                                raise  # handled by the drain-race catch
                            status, payload = 500, {"detail": str(e)}
                    elif method == "GET" and route in ("/openapi.json",
                                                       "/docs"):
                        # the reference's default FastAPI() auto-serves
                        # these (reference: api/app.py:47); /docs here is
                        # server-rendered HTML — no CDN assets, so it
                        # works inside an air-gapped pod
                        from .openapi import docs_html, openapi_spec

                        spec = openapi_spec(
                            allow_reload=self.allow_reload,
                            tile_enabled=self.tiler is not None,
                        )
                        status = 200
                        if route == "/openapi.json":
                            raw = (json.dumps(
                                spec, separators=(",", ":")).encode(),
                                "application/json")
                        else:
                            raw = (docs_html(spec).encode(),
                                   "text/html; charset=utf-8")
                    elif method == "POST" and route == "/infer":
                        loop = asyncio.get_running_loop()
                        status, payload = await loop.run_in_executor(
                            self._executor, self._infer, body,
                            headers.get("content-type", ""), query,
                        )
                    elif (method == "POST" and route == "/reload"
                          and self.allow_reload):
                        loop = asyncio.get_running_loop()
                        status, payload = await loop.run_in_executor(
                            self._executor, self._reload, body,
                        )
                    elif route in ("/ping", "/stats", "/metrics",
                                   "/openapi.json", "/docs", "/infer") or (
                            route == "/reload" and self.allow_reload):
                        # known path, wrong method — FastAPI answers 405
                        # with the permitted methods in Allow (RFC 9110
                        # §15.5.6), not 404
                        allow = ("POST" if route in ("/infer", "/reload")
                                 else "GET, HEAD")
                        status, payload = 405, {"detail": "Method Not Allowed"}
                        extra_headers = {"Allow": allow}
                    else:
                        status, payload = 404, {"detail": "Not Found"}
                except (TimeoutError, FuturesTimeoutError, RuntimeError):
                    # the executor shut down between the drain check and the
                    # dispatch (drain race) — still answer, don't drop; the
                    # timeout variants cover the /stats + /metrics IPC
                    # round-trip timing out against a draining worker
                    if not self._draining:
                        raise
                    status, payload, keep_alive = (
                        503, {"detail": "Server is shutting down"}, False)
                    raw = None
                if raw is not None:
                    await self._respond_raw(writer, status, raw[0], raw[1],
                                            close=not keep_alive,
                                            head_only=head_only)
                else:
                    await self._respond(writer, status, payload,
                                        close=not keep_alive,
                                        head_only=head_only,
                                        extra_headers=extra_headers)
                if not keep_alive:
                    return
        except (asyncio.IncompleteReadError, ConnectionResetError,
                asyncio.TimeoutError):
            pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:
                pass

    async def _read_chunked(self, reader: asyncio.StreamReader) -> bytes | None:
        """De-chunk a Transfer-Encoding: chunked body (RFC 9112 §7.1).

        Chunk extensions are ignored; trailer fields are read and discarded
        (none are meaningful to this API). Returns the reassembled body, or
        None once the running total exceeds MAX_BODY_BYTES — checked per
        chunk header, so an attacker cannot buffer an unbounded stream.
        Raises ValueError on malformed framing (caller answers 400).

        The caller bounds the ENTIRE read with one wait_for deadline; this
        coroutine deliberately has no per-read timeouts of its own."""
        total = 0
        parts: list[bytes] = []
        while True:
            line = await reader.readline()
            if not line:
                raise asyncio.IncompleteReadError(b"", None)
            size_field = line.strip().split(b";", 1)[0]  # drop extensions
            try:
                size = int(size_field, 16)
            except ValueError:
                raise ValueError(f"bad chunk size {size_field!r}")
            if size < 0:
                raise ValueError("negative chunk size")
            if size == 0:
                break
            total += size
            if total > self.MAX_BODY_BYTES:
                return None
            data = await reader.readexactly(size + 2)
            if data[-2:] != b"\r\n":
                raise ValueError("chunk data not CRLF-terminated")
            parts.append(data[:-2])
        # trailer section: header lines until the terminating blank line
        # (count-capped: the deadline alone would still let a flood of
        # trailer lines burn CPU for the full window)
        for _ in range(self.MAX_TRAILER_LINES):
            line = await reader.readline()
            if line in (b"\r\n", b"\n", b""):
                break
        else:
            raise ValueError("too many trailer lines")
        return b"".join(parts)

    async def _respond(self, writer, status: int, payload: dict,
                       close: bool = False, head_only: bool = False,
                       extra_headers: dict[str, str] | None = None) -> None:
        body = json.dumps(payload, separators=(",", ":")).encode()
        await self._respond_raw(writer, status, body, "application/json",
                                close=close, head_only=head_only,
                                extra_headers=extra_headers)

    async def _respond_raw(self, writer, status: int, body: bytes,
                           content_type: str, close: bool = False,
                           head_only: bool = False,
                           extra_headers: dict[str, str] | None = None) -> None:
        reasons = {200: "OK", 400: "Bad Request", 404: "Not Found",
                   405: "Method Not Allowed", 413: "Payload Too Large",
                   414: "URI Too Long",
                   431: "Request Header Fields Too Large",
                   500: "Internal Server Error", 501: "Not Implemented",
                   503: "Service Unavailable"}
        extras = "".join(f"{k}: {v}\r\n"
                         for k, v in (extra_headers or {}).items())
        head = (
            f"HTTP/1.1 {status} {reasons.get(status, 'OK')}\r\n"
            f"Content-Type: {content_type}\r\n"
            f"Content-Length: {len(body)}\r\n"
            f"Access-Control-Allow-Origin: *\r\n"
            f"{extras}"
            f"Connection: {'close' if close else 'keep-alive'}\r\n\r\n"
        ).encode()
        # HEAD: advertise the GET Content-Length but send no body (RFC 9110)
        writer.write(head if head_only else head + body)
        await writer.drain()

    # ------------------------------------------------------------- control
    async def serve_until_sigterm(self, server: asyncio.AbstractServer) -> None:
        """Serve on an already-bound listener with graceful drain on SIGTERM
        (k8s pod shutdown; reference has no counterpart — uvicorn is killed
        mid-request): stop accepting new connections, let in-flight requests
        finish, then return so a rolling update never drops a request.
        Shared by the single-process path (serve_forever) and each
        multi-process HTTP worker (serve/ipc._worker_main)."""
        loop = asyncio.get_running_loop()
        stop_event = asyncio.Event()
        try:
            import signal

            loop.add_signal_handler(signal.SIGTERM, stop_event.set)
        except (NotImplementedError, RuntimeError):  # non-main thread / win
            pass

        async with server:
            server_task = asyncio.ensure_future(server.serve_forever())
            stop_task = asyncio.ensure_future(stop_event.wait())
            done, _ = await asyncio.wait(
                {server_task, stop_task},
                return_when=asyncio.FIRST_COMPLETED)
            if stop_task in done:
                self.logger.info("SIGTERM: draining in-flight requests")
                self._draining = True
                server.close()
                await server.wait_closed()
                # in-flight handlers run in the executor; shutdown(wait=True)
                # blocks until every queued request has been answered
                await loop.run_in_executor(None, self._executor.shutdown)
                # request threads already waited on their tile futures above;
                # wait=False so a wedged device call can't hang the drain
                self._tile_executor.shutdown(wait=False)
                await asyncio.sleep(0.25)  # let final response writes flush
                self.logger.info("Drained; shutting down")
            server_task.cancel()

    async def serve_forever(self) -> None:
        self._server = await asyncio.start_server(self._handle, self.host, self.port)
        self.logger.info(f"Serving on {self.host}:{self.port}")
        await self.serve_until_sigterm(self._server)

    def run(self) -> None:
        asyncio.run(self.serve_forever())


def create_server(model_path: str, *, host: str = "0.0.0.0", port: int = 4000,
                  model_arch: str = "auto",
                  mode: str = "resize", max_batch_size: int = 8,
                  batch_timeout_ms: float = 3.0, compute_dtype=None,
                  tile_overlap: int = 32, log_dir: str | None = None,
                  image_size: int = 512, warmup: bool = True,
                  mesh=None, quantize: str | None = None,
                  allow_reload: bool = False, device=None) -> DeglareServer:
    """Build engine + (optional) tiler + server from a model artifact path.

    The model is the H100 serving configuration (``eval.harness.
    load_model_for_eval``: the fused kernels on); engine and tiler share
    it and launch on the device's default stream. ``warmup`` runs every
    batch bucket, so that the kernels are built and cuDNN has its plans
    before the server binds its port. ``device`` defaults to CUDA and
    raises without a card unless "cpu" is passed. ``quantize="int8"``
    serves int8 weights from the engine (``serve.engine``); the tiler runs
    the unquantized model, as the JAX server passes its tiler the
    unquantized parameters. ``mesh``: a ``parallel.mesh.LocalMesh``; the
    engine and the tiler keep one replica per device and split each batch
    over them, as the JAX server passes its mesh to both."""
    import torch

    from ..eval.harness import load_model_for_eval
    from ..parallel.mesh import replica_devices
    from .engine import InferenceEngine

    dev = replica_devices(device, mesh)[0]
    dtype = compute_dtype or torch.bfloat16
    if model_arch == "auto":
        from ..modelio import detect_model_arch

        model_arch = detect_model_arch(model_path)
    model, _params = load_model_for_eval(model_path, model_arch=model_arch,
                                         compute_dtype=dtype, device=dev)
    engine = InferenceEngine(
        model, image_size=image_size, max_batch_size=max_batch_size,
        batch_timeout_ms=batch_timeout_ms, compute_dtype=dtype, warmup=warmup,
        mesh=mesh, quantize=quantize, device=device,
    )
    tiler = None
    if mode in ("tile", "both"):
        from .tiling import TiledInference

        tiler = TiledInference(model, tile=image_size, overlap=tile_overlap,
                               compute_dtype=dtype, mesh=mesh, device=device)
    # "both" serves resize by default with ?mode=tile available per request
    default_mode = "tile" if mode == "tile" else "resize"
    model_info = {"model_path": model_path, "model": model_arch,
                  "quantize": quantize or "none",
                  "compute_dtype": str(dtype).removeprefix("torch.")}
    return DeglareServer(engine, host=host, port=port, mode=default_mode,
                         tiler=tiler, log_dir=log_dir, image_size=image_size,
                         allow_reload=allow_reload, model_info=model_info)
