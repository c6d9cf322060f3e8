"""API smoke-test CLI (reference: api/test_api.py:25-92 — ping/infer tests
with --test ping|infer|all, --url, --image flags).

    python -m image_enhancement_deglaring_tpu_torch.cli.test_api \
        --url http://localhost:4000 [--test ping|infer|stats|all] [--image X.png]

The JAX CLI's flags and output, on the standard library (``urllib``) and
the port's image path instead of ``requests`` and PIL. ``--image`` may be
a PNG or a JPEG; the answer is saved under the JAX CLI's name,
``enhanced_<basename>``, in the format its extension names, as PIL's
``save`` picks it: the PNG the server sent for ``.png``, and for ``.jpg``
or ``.jpeg`` the quality-75 JPEG PIL writes (``data.jpeg_encode``, byte
for byte). Another extension is refused before the request.
"""

from __future__ import annotations

import argparse
import base64
import json
import os
import urllib.error
import urllib.request


# the extensions PIL's save maps to its PNG and JPEG writers
_PNG_EXTS = (".png", ".apng")
_JPEG_EXTS = (".jpg", ".jpeg", ".jpe", ".jfif")


def _call(url: str, *, data: bytes | None = None, headers: dict | None = None,
          timeout: float = 10.0) -> tuple[int, bytes]:
    """(status, body) of one request; an HTTP error status is returned,
    not raised."""
    req = urllib.request.Request(url, data=data, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def multipart_image(payload: bytes, filename: str = "image.png",
                    boundary: str = "deglare-test-boundary") -> tuple[bytes, dict]:
    """A multipart/form-data body with one "image" field, and its headers."""
    body = (
        f"--{boundary}\r\n"
        f'Content-Disposition: form-data; name="image"; filename="{filename}"\r\n'
        "Content-Type: image/png\r\n\r\n"
    ).encode() + payload + f"\r\n--{boundary}--\r\n".encode()
    return body, {"Content-Type": f"multipart/form-data; boundary={boundary}"}


def test_ping(url: str) -> bool:
    status, body = _call(f"{url}/ping")
    ok = status == 200 and json.loads(body) == {"message": "pong"}
    print(f"Ping test: {'PASSED' if ok else 'FAILED'} "
          f"(status {status}, body {body.decode(errors='replace')})")
    return ok


def test_infer(url: str, image_path: str, out_dir: str = "test_output",
               timeout: float = 120.0) -> bool:
    from ..data.jpeg_encode import encode_jpeg_gray
    from ..serve.imaging import decode_image

    name = os.path.basename(image_path)
    ext = os.path.splitext(name)[1].lower()
    if ext not in _PNG_EXTS + _JPEG_EXTS:
        raise ValueError(f"cannot save the answer as {name!r}: the port writes PNG "
                         f"({', '.join(_PNG_EXTS)}) and JPEG ({', '.join(_JPEG_EXTS)}) files")
    with open(image_path, "rb") as f:
        body, headers = multipart_image(f.read(), os.path.basename(image_path))
    status, data = _call(f"{url}/infer", data=body, headers=headers, timeout=timeout)
    if status != 200:
        print(f"Infer test: FAILED (status {status}: {data[:200].decode(errors='replace')})")
        return False
    png = base64.b64decode(json.loads(data)["image"])
    img = decode_image(png)
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, f"enhanced_{name}")
    with open(out, "wb") as f:
        f.write(png if ext in _PNG_EXTS else encode_jpeg_gray(img.pixels))
    h, w = img.pixels.shape[:2]
    print(f"Infer test: PASSED (output ({w}, {h}) {img.mode} saved to {out})")
    return True


def test_observability(url: str) -> bool:
    """Probe the endpoints beyond the reference API: /stats (JSON),
    /metrics (Prometheus text), /openapi.json (spec)."""
    ok = True
    status, body = _call(f"{url}/stats")
    ok &= status == 200 and "requests_served" in json.loads(body)
    status, body = _call(f"{url}/metrics")
    ok &= status == 200 and b"deglaring_requests_served_total" in body
    status, body = _call(f"{url}/openapi.json")
    ok &= status == 200 and "/infer" in json.loads(body)["paths"]
    print(f"Observability test: {'PASSED' if ok else 'FAILED'}")
    return ok


def _guarded(name: str, fn, *args) -> bool:
    """An unreachable/broken server is the most common smoke-test failure —
    it must read as FAILED with the reason, not a raw traceback."""
    try:
        return fn(*args)
    except Exception as e:
        print(f"{name} test: FAILED ({type(e).__name__}: {e})")
        return False


def main(argv=None):
    p = argparse.ArgumentParser(description="Test the de-glaring API")
    # "stats" probes /stats + /metrics + /openapi.json — endpoints beyond
    # the reference API. "all" keeps the reference's meaning (ping+infer)
    # so the script still passes when pointed at the reference server.
    p.add_argument("--test", choices=["ping", "infer", "stats", "all"],
                   default="all")
    p.add_argument("--url", default="http://localhost:4000")
    p.add_argument("--image", default=None)
    p.add_argument("--timeout", type=float, default=120.0,
                   help="infer request timeout in seconds (default matches "
                        "the reference script's 120)")
    args = p.parse_args(argv)

    ok = True
    if args.test in ("ping", "all"):
        ok &= _guarded("Ping", test_ping, args.url)
    if args.test in ("infer", "all"):
        if not args.image:
            print("Infer test skipped: provide --image path")
        else:
            ok &= _guarded("Infer", test_infer, args.url, args.image,
                           "test_output", args.timeout)
    if args.test == "stats":
        ok &= _guarded("Observability", test_observability, args.url)
    return 0 if ok else 1


if __name__ == "__main__":
    import sys

    sys.exit(main())
