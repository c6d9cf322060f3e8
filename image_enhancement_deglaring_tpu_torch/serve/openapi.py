"""OpenAPI 3.0 schema + self-contained docs page for the serving API.

A copy of ``image_enhancement_deglaring_tpu.serve.openapi``: the spec is
the JAX server's, word for word, so the two servers document one API.

The reference app is a default ``FastAPI()`` (reference: api/app.py:47),
which auto-serves ``GET /openapi.json`` and an interactive ``GET /docs``
page. This module gives the stdlib server the same surface: a
hand-authored spec that reflects the running server's configuration
(reload enabled? tiling enabled?), and a zero-dependency HTML rendering
of it — the FastAPI Swagger page pulls its UI from a CDN, which an
air-gapped pod cannot reach, so ``/docs`` here is server-rendered
static HTML instead.
"""

from __future__ import annotations

import html as _html

_ERROR_SCHEMA = {
    "type": "object",
    "properties": {"detail": {"type": "string"}},
    "required": ["detail"],
}


def _json_response(description: str, schema: dict) -> dict:
    return {
        "description": description,
        "content": {"application/json": {"schema": schema}},
    }


def openapi_spec(*, allow_reload: bool = False,
                 tile_enabled: bool = False) -> dict:
    """Build the OpenAPI document for this server instance's routes."""
    infer_params = []
    if tile_enabled:
        infer_params.append({
            "name": "mode",
            "in": "query",
            "required": False,
            "schema": {"type": "string", "enum": ["resize", "tile"]},
            "description": "Per-request processing mode: 'resize' "
                           "downsamples to the model resolution and back "
                           "(the reference behavior); 'tile' runs the "
                           "U-Net over overlapping full-resolution tiles.",
        })

    paths: dict = {
        "/ping": {
            "get": {
                "summary": "Liveness probe",
                "responses": {"200": _json_response(
                    "Service is up",
                    {"type": "object",
                     "properties": {"message": {"type": "string",
                                                "example": "pong"}}},
                )},
            }
        },
        "/infer": {
            "post": {
                "summary": "De-glare one image",
                "description": "Multipart upload, field name 'image' "
                               "(PNG/JPEG/...). Returns the enhanced "
                               "grayscale image as base64 PNG at the "
                               "original resolution.",
                "parameters": infer_params,
                "requestBody": {
                    "required": True,
                    "content": {"multipart/form-data": {"schema": {
                        "type": "object",
                        "properties": {"image": {"type": "string",
                                                 "format": "binary"}},
                        "required": ["image"],
                    }}},
                },
                "responses": {
                    "200": _json_response(
                        "Enhanced image",
                        {"type": "object",
                         "properties": {"image": {
                             "type": "string",
                             "format": "byte",
                             "description": "base64-encoded PNG"}}},
                    ),
                    "400": _json_response("No image provided / bad mode",
                                          _ERROR_SCHEMA),
                    "413": _json_response("Body exceeds the size limit",
                                          _ERROR_SCHEMA),
                    "500": _json_response("Image processing failed",
                                          _ERROR_SCHEMA),
                },
            }
        },
        "/stats": {
            "get": {
                "summary": "Serving statistics (JSON)",
                "description": "Engine request counter, latency "
                               "percentiles, mean batch fill, and host "
                               "phase timings (decode/engine/encode p50).",
                "responses": {
                    "200": _json_response("Current statistics",
                                          {"type": "object"}),
                    "500": _json_response("Engine unavailable",
                                          _ERROR_SCHEMA),
                },
            }
        },
        "/metrics": {
            "get": {
                "summary": "Serving statistics (Prometheus)",
                "description": "The /stats numbers in Prometheus text "
                               "exposition format v0.0.4.",
                "responses": {
                    "200": {
                        "description": "Exposition text",
                        "content": {"text/plain": {
                            "schema": {"type": "string"}}},
                    },
                    "500": _json_response("Engine unavailable",
                                          _ERROR_SCHEMA),
                },
            }
        },
    }
    if allow_reload:
        paths["/reload"] = {
            "post": {
                "summary": "Zero-downtime weight swap",
                "description": "Load a same-family checkpoint "
                               "(.onnx/.pth/.npz/orbax dir) and swap it "
                               "in atomically; in-flight requests finish "
                               "on the old weights.",
                "requestBody": {
                    "required": True,
                    "content": {"application/json": {"schema": {
                        "type": "object",
                        "properties": {"model_path": {"type": "string"}},
                        "required": ["model_path"],
                    }}},
                },
                "responses": {
                    "200": _json_response("Weights swapped",
                                          {"type": "object"}),
                    "400": _json_response("Bad path or family mismatch",
                                          _ERROR_SCHEMA),
                },
            }
        }

    return {
        "openapi": "3.0.3",
        "info": {
            "title": "Image Enhancement (De-glaring) API",
            "description": "TPU-native glare-removal serving API. "
                           "Request/response compatible with the "
                           "reference FastAPI app.",
            "version": "1.0.0",
        },
        "paths": paths,
    }


def docs_html(spec: dict) -> str:
    """Render the spec as a self-contained HTML page (no external JS)."""
    info = spec.get("info", {})
    parts = [
        "<!doctype html><html><head><meta charset='utf-8'>",
        f"<title>{_html.escape(info.get('title', 'API'))}</title>",
        "<style>body{font-family:sans-serif;max-width:56rem;margin:2rem "
        "auto;padding:0 1rem;color:#222}code,pre{background:#f4f4f4;"
        "border-radius:4px;padding:2px 5px}pre{padding:10px;overflow-x:"
        "auto}h2{border-bottom:1px solid #ddd;padding-bottom:4px}"
        ".method{display:inline-block;font-weight:bold;text-transform:"
        "uppercase;background:#2a6;color:#fff;border-radius:4px;"
        "padding:2px 8px;margin-right:8px}.method.post{background:#26a}"
        "</style></head><body>",
        f"<h1>{_html.escape(info.get('title', 'API'))}</h1>",
        f"<p>{_html.escape(info.get('description', ''))}</p>",
        "<p>Machine-readable spec: <a href='/openapi.json'>"
        "/openapi.json</a></p>",
    ]
    for path, methods in spec.get("paths", {}).items():
        for method, op in methods.items():
            parts.append(
                f"<h2><span class='method {method}'>{method}</span>"
                f"<code>{_html.escape(path)}</code></h2>"
            )
            if op.get("summary"):
                parts.append(f"<p><b>{_html.escape(op['summary'])}</b></p>")
            if op.get("description"):
                parts.append(f"<p>{_html.escape(op['description'])}</p>")
            for param in op.get("parameters", []):
                parts.append(
                    f"<p>Query parameter <code>"
                    f"{_html.escape(param['name'])}</code>: "
                    f"{_html.escape(param.get('description', ''))}</p>"
                )
            body = op.get("requestBody")
            if body:
                ctype = next(iter(body.get("content", {"": None})))
                parts.append(f"<p>Request body: <code>"
                             f"{_html.escape(ctype)}</code></p>")
            responses = op.get("responses", {})
            if responses:
                rows = ", ".join(
                    f"<code>{_html.escape(code)}</code> "
                    f"{_html.escape(r.get('description', ''))}"
                    for code, r in responses.items()
                )
                parts.append(f"<p>Responses: {rows}</p>")
    parts.append("</body></html>")
    return "".join(parts)

