"""Minimal HTTP endpoint exposing the embeddable prover API + demo page.

Copy of ``go_snark_study_tpu/server.py``: it serves the port's
:mod:`.embed`, and ``/snark.js`` from the port's own ``webclient/``.

The analog of the reference's wasm demo harness (wasm/server.js — an express
static server — plus wasm/index.html:1-17 and index.js, which embeds complete
demo vectors for the cubic circuit and drives generateProofs/verifyProofs in
the browser).  Ours serves the four embed functions as JSON POST endpoints
with the python stdlib only:

    POST /generateProofs       {circuit, setup, px, inputs}
    POST /verifyProofs         {proof, setup, publicInputs}
    POST /grothGenerateProofs  {circuit, setup, px, inputs}
    POST /grothVerifyProofs    {proof, setup, publicInputs}

and the browser harness:

    GET /                   demo page (prove + verify buttons, like index.js)
    GET /demo-vectors.json  cubic-circuit demo vectors in the *String wire
                            dialect — computed fresh at first request (the
                            reference hardcodes its vectors in index.js; ours
                            are generated, not copied)

Run: ``python -m go_snark_study_tpu_torch.server [port]`` (default 8080).
"""

from __future__ import annotations

import json
import sys
from http.server import BaseHTTPRequestHandler, HTTPServer

from . import embed

__all__ = ["make_server", "main", "demo_vectors"]

_DEMO_CACHE: dict = {}


def demo_vectors() -> dict:
    """Compile the cubic circuit (y = x^3 + x + 5, x=3, y=35 — the same demo
    the reference's wasm/index.js ships), run the Pinocchio trusted setup,
    and return everything the demo page needs, in the decimal *String wire
    dialect."""
    if _DEMO_CACHE:
        return _DEMO_CACHE
    from .api import compile_circuit
    from .models import groth16 as g16, pinocchio as pgh
    from .utils import base10

    src = (
        "func main(private s0, public s1):\n"
        "\ts2 = s0 * s0\n"
        "\ts3 = s2 * s0\n"
        "\ts4 = s3 + s0\n"
        "\ts5 = s4 + 5\n"
        "\tequals(s1, s5)\n"
        "\tout = 1 * 1\n"
    )
    bundle = compile_circuit(source=src, private_inputs=[3], public_inputs=[35])
    c = bundle.circuit
    setup = pgh.generate_trusted_setup(
        len(c.witness), c, bundle.alphas, bundle.betas, bundle.gammas
    ).strip_toxic()
    gsetup = g16.generate_trusted_setup(
        len(c.witness), c, bundle.alphas, bundle.betas, bundle.gammas
    ).strip_toxic()
    _DEMO_CACHE.update(
        {
            "circuit": base10.circuit_to_dict(c),
            "setup": base10.setup_to_dict(setup),
            "grothSetup": base10.groth_setup_to_dict(gsetup),
            "px": base10.arr(bundle.px),
            "inputs": ["3"],
            "publicInputs": ["35"],
        }
    )
    return _DEMO_CACHE


_DEMO_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>go-snark-tpu demo</title></head>
<body>
<h3>go-snark-tpu &mdash; in-browser prove/verify demo</h3>
<p>Cubic circuit y = x&sup3; + x + 5 with x = 3, y = 35 (the reference's
wasm demo flow).  "In browser" runs the pure-JS BigInt prover/verifier
(<code>/snark.js</code> &mdash; the analog of the reference's wasm-compiled
Go prover, wasm/go-snark-wasm-wrapper.go:21-26); "on server" calls the
Python embed API.</p>
<button id="prove">prove in browser</button>
<button id="verify" disabled>verify in browser</button>
<button id="sprove">prove on server</button>
<button id="sverify" disabled>verify on server</button>
<pre id="out">loading demo vectors...</pre>
<script src="/snark.js"></script>
<script>
let vectors = null, proof = null;
const out = document.getElementById("out");
const enable = () => { document.getElementById("verify").disabled = false;
                       document.getElementById("sverify").disabled = false; };
fetch("/demo-vectors.json").then(r => r.json()).then(v => {
  vectors = v; out.textContent = "demo vectors loaded; click a prove button";
});
document.getElementById("prove").onclick = () => {
  out.textContent = "proving in browser...";
  setTimeout(() => {
    const t0 = performance.now();
    proof = JSON.parse(gosnark.generateProofs(
      JSON.stringify(vectors.circuit), JSON.stringify(vectors.setup),
      JSON.stringify(vectors.px), JSON.stringify(vectors.inputs)));
    out.textContent = "browser proof (" + (performance.now()-t0).toFixed(0) +
      " ms):\\n" + JSON.stringify(proof, null, 1);
    enable();
  }, 10);
};
document.getElementById("verify").onclick = () => {
  out.textContent = "verifying in browser (10 pairings)...";
  setTimeout(() => {
    const t0 = performance.now();
    const res = JSON.parse(gosnark.verifyProofs(
      JSON.stringify(proof), JSON.stringify(vectors.setup),
      JSON.stringify(vectors.publicInputs)));
    out.textContent = "browser verify (" + (performance.now()-t0).toFixed(0) +
      " ms): " + JSON.stringify(res);
  }, 10);
};
document.getElementById("sprove").onclick = async () => {
  out.textContent = "proving on server...";
  const r = await fetch("/generateProofs", {method: "POST",
    body: JSON.stringify({circuit: vectors.circuit, setup: vectors.setup,
                          px: vectors.px, inputs: vectors.inputs})});
  proof = await r.json();
  out.textContent = JSON.stringify(proof, null, 1);
  enable();
};
document.getElementById("sverify").onclick = async () => {
  out.textContent = "verifying on server...";
  const r = await fetch("/verifyProofs", {method: "POST",
    body: JSON.stringify({proof: proof, setup: vectors.setup,
                          publicInputs: vectors.publicInputs})});
  out.textContent = JSON.stringify(await r.json());
};
</script>
</body></html>
"""


class _Handler(BaseHTTPRequestHandler):
    def _reply(self, code: int, payload: dict | str) -> None:
        body = payload if isinstance(payload, str) else json.dumps(payload)
        data = body.encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self) -> None:  # noqa: N802 (stdlib API)
        if self.path in ("/", "/index.html"):
            data = _DEMO_PAGE.encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/html; charset=utf-8")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)
        elif self.path == "/snark.js":
            import os

            js = os.path.join(os.path.dirname(__file__), "webclient", "snark.js")
            with open(js, "rb") as f:
                data = f.read()
            self.send_response(200)
            self.send_header("Content-Type", "application/javascript")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)
        elif self.path == "/demo-vectors.json":
            try:
                self._reply(200, demo_vectors())
            except Exception as e:
                self._reply(500, {"error": str(e)})
        else:
            self._reply(404, {"error": f"unknown path {self.path}"})

    def do_POST(self) -> None:  # noqa: N802 (stdlib API)
        try:
            length = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(length) or b"{}")
            j = json.dumps
            if self.path == "/generateProofs":
                out = embed.generate_proofs(
                    j(req["circuit"]), j(req["setup"]), j(req["px"]), j(req["inputs"])
                )
            elif self.path == "/verifyProofs":
                out = embed.verify_proofs(
                    j(req["proof"]), j(req["setup"]), j(req["publicInputs"])
                )
            elif self.path == "/grothGenerateProofs":
                out = embed.groth_generate_proofs(
                    j(req["circuit"]), j(req["setup"]), j(req["px"]), j(req["inputs"])
                )
            elif self.path == "/grothVerifyProofs":
                out = embed.groth_verify_proofs(
                    j(req["proof"]), j(req["setup"]), j(req["publicInputs"])
                )
            else:
                self._reply(404, {"error": f"unknown endpoint {self.path}"})
                return
            self._reply(200, out)
        except Exception as e:  # report, don't crash the server
            self._reply(400, {"error": str(e)})

    def log_message(self, fmt, *args):  # quiet
        pass


def make_server(port: int = 8080) -> HTTPServer:
    return HTTPServer(("127.0.0.1", port), _Handler)


def main(argv=None) -> int:
    port = int((argv or sys.argv[1:] or ["8080"])[0])
    srv = make_server(port)
    print(f"go-snark embed API listening on 127.0.0.1:{port}")
    srv.serve_forever()
    return 0


if __name__ == "__main__":
    sys.exit(main())
