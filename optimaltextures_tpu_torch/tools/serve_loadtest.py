"""Live HTTP load test of the serving layer (the counterpart of
``tools/serve_loadtest.py``).

Starts ``serve.serve()`` in this process (one worker on the GPU), fires
``--clients`` concurrent unseeded synthesis requests until ``--requests``
have completed, and prints one JSON line: the warm single-request latency,
the sustained requests/s, the cohort sizes seen, the coalescing counters,
and the card's name and power limit.

    python -m optimaltextures_tpu_torch.tools.serve_loadtest \\
        --size 512 --clients 4 --requests 24 [--coalesce 1]

The workload is the default schedule (5 passes, 500 iterations) in bf16
convs, the JAX tool's; the style is docs/samples/graffiti_cholhist_256.png.
"""

import argparse
import base64
import concurrent.futures
import json
import os
import subprocess
import threading
import time
import urllib.request

STYLE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "docs", "samples", "graffiti_cholhist_256.png")


def card(device: str) -> str:
    """The card's name and power limit as nvidia-smi reports them ("cpu" on
    the CPU)."""
    if device == "cpu":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--clients", type=int, default=4)
    p.add_argument("--requests", type=int, default=24,
                   help="total timed requests (after warm-up)")
    p.add_argument("--coalesce", type=int, default=8,
                   help="max cohort size (1 = coalescing off)")
    p.add_argument("--config", action="append", default=[],
                   metavar="KEY=JSON", help="extra config fields")
    p.add_argument("--style", default=STYLE)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args()

    from optimaltextures_tpu_torch import serve

    srv = serve.serve(port=0, workers=1, coalesce=args.coalesce,
                      device=args.device)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"

    cfg = {"size": args.size, "conv_dtype": "bfloat16"}
    for kv in args.config:
        k, _, v = kv.partition("=")
        cfg[k] = json.loads(v)
    with open(args.style, "rb") as f:
        payload = json.dumps({
            "config": cfg,
            "style_b64": [base64.b64encode(f.read()).decode()],
        }).encode()

    def post():
        req = urllib.request.Request(
            f"{url}/v1/synthesize", data=payload,
            headers={"Content-Type": "application/json"})
        t0 = time.time()
        with urllib.request.urlopen(req, timeout=1200) as r:
            body = r.read()
            cohort = r.headers.get("X-Optex-Cohort")
        return time.time() - t0, cohort, len(body)

    try:
        # warm-up: the kernels' first launches, the batch sizes the cohorts
        # will hit (1 and the padded queue depth), then a warm single
        for _ in range(2):
            post()
        if args.coalesce > 1 and args.clients > 1:
            with concurrent.futures.ThreadPoolExecutor(args.clients) as ex:
                list(ex.map(lambda _: post(), range(args.clients * 2)))
        warm_single = min(post()[0] for _ in range(3))

        t0 = time.time()
        with concurrent.futures.ThreadPoolExecutor(args.clients) as ex:
            results = list(ex.map(lambda _: post(), range(args.requests)))
        wall = time.time() - t0

        with urllib.request.urlopen(f"{url}/metrics") as r:
            metrics = r.read().decode()
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join()
    counters = {ln.rsplit(" ", 1)[0]: float(ln.rsplit(" ", 1)[1])
                for ln in metrics.splitlines() if not ln.startswith("#")}
    latencies = sorted(t for t, _, _ in results)
    print(json.dumps({
        "device": card(args.device),
        "size": args.size, "clients": args.clients,
        "coalesce": args.coalesce, "requests": args.requests,
        "config": cfg,
        "warm_single_latency_s": warm_single,
        "wall_s": wall,
        "req_per_s": args.requests / wall,
        "mean_latency_s": sum(latencies) / len(latencies),
        "p50_latency_s": latencies[len(latencies) // 2],
        "max_latency_s": latencies[-1],
        "cohort_sizes_seen": sorted({int(c) for _, c, _ in results
                                     if c is not None}),
        "coalesced_requests_total":
            counters.get("optex_coalesced_requests_total", 0.0),
        "coalesced_cohorts_total":
            counters.get("optex_coalesced_cohorts_total", 0.0),
    }), flush=True)


if __name__ == "__main__":
    main()
