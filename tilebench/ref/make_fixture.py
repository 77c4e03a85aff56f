"""Deterministic synthetic-city OSM fixture generator (a frozen copy of
`tools/make_fixture.py`, so that the benchmark's city cannot change).

The reference repo's test extract (nano_moscow.osm) is stripped from
this snapshot and the environment has no network access, so golden and
benchmark corpora are generated synthetically: a city-like scene with a
road grid + ring road, dense building blocks, parks, a river
(multipolygon with island holes), rail, and tagged POI nodes.  Output is
standard OSM XML consumable by any OSM toolchain.

Usage: python tools/make_fixture.py OUT.osm [--blocks N] [--seed S]
                                            [--pathological]

`--pathological` additionally injects, AT DENSITY, the malformed
content real extracts carry — the same robustness surface the
reference handles individually (`find_polygons.rs:141-149` unmatched
multipolygon segments, `importer.rs:334-353` repeated node pairs,
`styler.rs:288-298` unparseable style values), but spread across the
whole city so import -> style -> render -> parity runs it under load:

* self-intersecting (bowtie) building rings in ~1/3 of blocks;
* self-touching (vertex-reuse figure-eight) park rings in ~1/4;
* ways with repeated node pairs + zero-length segments in ~1/5;
* degenerate ways (single node / all nodes identical) in ~1/6;
* four 1,000-node ways crossing the full extent (hundreds of z18
  tile columns each);
* multipolygon relations with unmatched outer segments (must all be
  dropped with a warning) alongside VALID multipolygons whose rings
  are split into 5-8 shuffled, partly reversed member ways (must all
  assemble);
* exotic tag values: non-numeric `layer`, unicode/entity names,
  ~500-char values.
"""

from __future__ import annotations

import argparse
import math
import random
from typing import Dict, List, Tuple

CENTER_LAT = 47.141
CENTER_LON = 9.521
# Rough degrees-per-meter at the center latitude.
DEG_LAT_PER_M = 1.0 / 111_320.0


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("output")
    ap.add_argument("--blocks", type=int, default=14, help="city grid blocks per side")
    ap.add_argument("--seed", type=int, default=20260816)
    ap.add_argument(
        "--pathological",
        action="store_true",
        help="inject city-wide malformed content (see module docstring)",
    )
    args = ap.parse_args(argv)

    rng = random.Random(args.seed)
    deg_lon_per_m = DEG_LAT_PER_M / math.cos(math.radians(CENTER_LAT))

    nodes: List[Tuple[int, float, float, Dict[str, str]]] = []
    ways: List[Tuple[int, List[int], Dict[str, str]]] = []
    relations: List[Tuple[int, List[Tuple[int, str]], Dict[str, str]]] = []
    next_node_id = [1]
    next_way_id = [1_000_000]
    next_rel_id = [5_000_000]

    def add_node(x_m: float, y_m: float, tags: Dict[str, str] | None = None) -> int:
        nid = next_node_id[0]
        next_node_id[0] += 1
        lat = CENTER_LAT - y_m * DEG_LAT_PER_M
        lon = CENTER_LON + x_m * deg_lon_per_m
        nodes.append((nid, lat, lon, tags or {}))
        return nid

    def add_way(node_ids: List[int], tags: Dict[str, str]) -> int:
        wid = next_way_id[0]
        next_way_id[0] += 1
        ways.append((wid, node_ids, tags))
        return wid

    def add_rel(members: List[Tuple[int, str]], tags: Dict[str, str]) -> int:
        rid = next_rel_id[0]
        next_rel_id[0] += 1
        relations.append((rid, members, tags))
        return rid

    block_m = 120.0
    n = args.blocks
    half = n * block_m / 2.0

    # --- road grid ---
    grid_nodes: Dict[Tuple[int, int], int] = {}
    for i in range(n + 1):
        for j in range(n + 1):
            jitter = lambda: rng.uniform(-6.0, 6.0)
            grid_nodes[(i, j)] = add_node(
                -half + i * block_m + jitter(), -half + j * block_m + jitter()
            )

    def road_class(idx: int) -> Dict[str, str]:
        if idx % 7 == 3:
            return {"highway": "primary", "name": f"Prime Street {idx}"}
        if idx % 3 == 1:
            return {"highway": "secondary", "name": f"Second Avenue {idx}"}
        return {"highway": "residential", "name": f"Quiet Lane {idx}"}

    for i in range(n + 1):
        add_way([grid_nodes[(i, j)] for j in range(n + 1)], road_class(i))
    for j in range(n + 1):
        add_way([grid_nodes[(i, j)] for i in range(n + 1)], road_class(j + 1))

    # Ring road around the city (trunk).
    ring_ids = []
    for k in range(48):
        ang = 2 * math.pi * k / 48
        r = half * 1.25 + rng.uniform(-15, 15)
        ring_ids.append(add_node(r * math.cos(ang), r * math.sin(ang)))
    ring_ids.append(ring_ids[0])
    add_way(ring_ids, {"highway": "trunk", "name": "Ring Road"})

    # Rail line crossing the city diagonally.
    rail_ids = [
        add_node(-half * 1.4 + t * (2.8 * half) / 30.0,
                 -half * 1.1 + t * (2.0 * half) / 30.0 + 30 * math.sin(t / 3.0))
        for t in range(31)
    ]
    add_way(rail_ids, {"railway": "rail"})

    # --- buildings: several per block ---
    for i in range(n):
        for j in range(n):
            if rng.random() < 0.12:
                continue  # empty lot / park handled below
            bx0 = -half + i * block_m
            by0 = -half + j * block_m
            for _ in range(rng.randint(2, 5)):
                w = rng.uniform(18, 45)
                h = rng.uniform(15, 40)
                x = bx0 + rng.uniform(12, block_m - 12 - w)
                y = by0 + rng.uniform(12, block_m - 12 - h)
                rot = rng.uniform(-0.15, 0.15)
                cos_r, sin_r = math.cos(rot), math.sin(rot)
                corners = [(0, 0), (w, 0), (w, h), (0, h)]
                ids = []
                for (cx, cy) in corners:
                    rx = x + cx * cos_r - cy * sin_r
                    ry = y + cx * sin_r + cy * cos_r
                    ids.append(add_node(rx, ry))
                ids.append(ids[0])
                tags = {"building": "yes"}
                if rng.random() < 0.05:
                    tags["building"] = "commercial"
                add_way(ids, tags)

    # --- parks (green areas) ---
    for _ in range(max(4, n // 2)):
        cx = rng.uniform(-half, half - block_m)
        cy = rng.uniform(-half, half - block_m)
        ids = []
        m = rng.randint(6, 10)
        for k in range(m):
            ang = 2 * math.pi * k / m
            r = rng.uniform(35, 75)
            ids.append(add_node(cx + r * math.cos(ang), cy + r * math.sin(ang)))
        ids.append(ids[0])
        add_way(ids, {"leisure": "park", "name": f"Park {len(ways)}"})

    # --- river with an island (multipolygon with hole) ---
    bank_n, bank_s = [], []
    for t in range(25):
        x = -half * 1.5 + t * (3.0 * half) / 24.0
        yc = 0.35 * half * math.sin(x / (half * 0.6)) + half * 0.55
        bank_n.append(add_node(x, yc - rng.uniform(22, 30)))
        bank_s.append(add_node(x, yc + rng.uniform(22, 30)))
    outer_ids = bank_n + bank_s[::-1] + [bank_n[0]]
    outer_way = add_way(outer_ids, {})

    isl = []
    mid_x = 0.0
    mid_y = 0.35 * half * math.sin(mid_x / (half * 0.6)) + half * 0.55
    for k in range(8):
        ang = 2 * math.pi * k / 8
        isl.append(add_node(mid_x + 14 * math.cos(ang) * 2.2, mid_y + 9 * math.sin(ang)))
    isl.append(isl[0])
    island_way = add_way(isl, {})
    add_rel(
        [(outer_way, "outer"), (island_way, "inner")],
        {"type": "multipolygon", "natural": "water", "name": "Synth River"},
    )

    # --- POI nodes ---
    pois = [
        ("cafe", "Cafe Mira"), ("restaurant", "Olive"), ("bank", "First Bank"),
        ("pharmacy", "Pills"), ("pub", "The Fox"), ("library", "Reading Room"),
    ]
    for _ in range(n * 6):
        amenity, name = pois[rng.randrange(len(pois))]
        x = rng.uniform(-half, half)
        y = rng.uniform(-half, half)
        add_node(x, y, {"amenity": amenity, "name": name})

    # --- pathological content (opt-in) ---
    if args.pathological:
        long_name = "Улица " + "Ω中文é " * 80  # ~560 chars, non-Latin

        for i in range(n):
            for j in range(n):
                bx0 = -half + i * block_m
                by0 = -half + j * block_m
                cx = bx0 + block_m / 2
                cy = by0 + block_m / 2
                if (i + j) % 3 == 0:
                    # Bowtie (self-intersecting) building ring.
                    w = rng.uniform(14, 30)
                    h = rng.uniform(10, 24)
                    a = add_node(cx - w, cy - h)
                    b = add_node(cx + w, cy + h)  # crossing diagonal
                    c = add_node(cx + w, cy - h)
                    d = add_node(cx - w, cy + h)
                    add_way(
                        [a, b, c, d, a],
                        {"building": "yes", "layer": "très haut"},
                    )
                if (i + j) % 4 == 1:
                    # Figure-eight park: two loops sharing one pinch node.
                    pinch = add_node(cx, cy)
                    r = rng.uniform(15, 28)
                    left = [
                        add_node(cx - r + r * math.cos(a_), cy + r * math.sin(a_))
                        for a_ in (0.8, 2.2, 3.6, 5.0)
                    ]
                    right = [
                        add_node(cx + r + r * math.cos(a_), cy + r * math.sin(a_))
                        for a_ in (4.0, 5.4, 0.6, 2.0)
                    ]
                    add_way(
                        [pinch] + left + [pinch] + right + [pinch],
                        {"leisure": "park", "name": long_name},
                    )
                if (i + j) % 5 == 2:
                    # Repeated node pairs + zero-length segments.
                    a = add_node(cx - 20, cy)
                    b = add_node(cx + 20, cy + rng.uniform(-8, 8))
                    add_way(
                        [a, b, a, b, b, b, a],
                        {"highway": "residential", "name": 'Dup "&<>" way'},
                    )
                if (i + j) % 6 == 3:
                    # Degenerate ways: single node; all nodes identical.
                    a = add_node(cx, cy - 10)
                    add_way([a], {"highway": "residential"})
                    add_way([a, a, a], {"highway": "residential"})

        # Four 1,000-node ways crossing the full extent and beyond.
        for k in range(4):
            ang = math.pi * (0.13 + 0.47 * k)
            dx, dy = math.cos(ang), math.sin(ang)
            pts = []
            for t in range(1000):
                s = -1.6 * half + t * (3.2 * half) / 999.0
                wob = 25.0 * math.sin(t / 17.0 + k)
                pts.append(add_node(s * dx - wob * dy, s * dy + wob * dx))
            add_way(
                pts,
                {"highway": "trunk", "name": f"Transect {k}"}
                if k % 2 == 0
                else {"railway": "rail", "layer": str(k - 2)},
            )

        # Multipolygons: 8 broken (unmatched outer segment -> dropped with
        # a warning) and 8 valid ones whose rings are split into shuffled,
        # partly reversed member ways (-> must assemble).
        for k in range(16):
            broken = k < 8
            cx = rng.uniform(-half * 0.9, half * 0.9)
            cy = rng.uniform(-half * 0.9, half * 0.9)
            m = 12
            ring = [
                add_node(
                    cx + rng.uniform(30, 55) * math.cos(2 * math.pi * q / m),
                    cy + rng.uniform(30, 55) * math.sin(2 * math.pi * q / m),
                )
                for q in range(m)
            ]
            closed = ring + [ring[0]]
            # Split the closed ring into 4-6 consecutive chunks.
            n_cuts = rng.randint(4, 6)
            cuts = sorted(rng.sample(range(1, m), n_cuts - 1))
            bounds = [0] + cuts + [m]
            pieces = [closed[a : b + 1] for a, b in zip(bounds, bounds[1:])]
            if broken:
                pieces[rng.randrange(len(pieces))] = [
                    add_node(cx + 200, cy + 200),
                    add_node(cx + 240, cy + 190),
                ]  # dangling segment: ring cannot close
            members = []
            for piece in pieces:
                if rng.random() < 0.5:
                    piece = piece[::-1]
                members.append((add_way(piece, {}), "outer"))
            rng.shuffle(members)
            if not broken:
                # Inner hole, itself split in two.
                hole = [
                    add_node(
                        cx + 12 * math.cos(2 * math.pi * q / 6),
                        cy + 12 * math.sin(2 * math.pi * q / 6),
                    )
                    for q in range(6)
                ]
                hc = hole + [hole[0]]
                members.append((add_way(hc[:4], {}), "inner"))
                members.append((add_way(hc[3:], {}), "inner"))
            add_rel(
                members,
                {
                    "type": "multipolygon",
                    "natural": "water",
                    "name": f"{'Broken' if broken else 'Split'} MP {k}",
                },
            )

    # --- write XML ---
    def esc(s: str) -> str:
        return (
            s.replace("&", "&amp;").replace("<", "&lt;").replace(">", "&gt;")
            .replace('"', "&quot;")
        )

    with open(args.output, "w", encoding="utf-8") as f:
        f.write("<?xml version='1.0' encoding='UTF-8'?>\n")
        f.write('<osm version="0.6" generator="osm_renderer_tpu-fixture">\n')
        for nid, lat, lon, tags in nodes:
            if tags:
                f.write(f'  <node id="{nid}" lat="{lat:.7f}" lon="{lon:.7f}">\n')
                for k, v in tags.items():
                    f.write(f'    <tag k="{esc(k)}" v="{esc(v)}"/>\n')
                f.write("  </node>\n")
            else:
                f.write(f'  <node id="{nid}" lat="{lat:.7f}" lon="{lon:.7f}"/>\n')
        for wid, nds, tags in ways:
            f.write(f'  <way id="{wid}">\n')
            for r in nds:
                f.write(f'    <nd ref="{r}"/>\n')
            for k, v in tags.items():
                f.write(f'    <tag k="{esc(k)}" v="{esc(v)}"/>\n')
            f.write("  </way>\n")
        for rid, members, tags in relations:
            f.write(f'  <relation id="{rid}">\n')
            for wid, role in members:
                f.write(f'    <member type="way" ref="{wid}" role="{role}"/>\n')
            for k, v in tags.items():
                f.write(f'    <tag k="{esc(k)}" v="{esc(v)}"/>\n')
            f.write("  </relation>\n")
        f.write("</osm>\n")

    print(
        f"wrote {args.output}: {len(nodes)} nodes, {len(ways)} ways, "
        f"{len(relations)} relations"
    )


if __name__ == "__main__":
    main()
