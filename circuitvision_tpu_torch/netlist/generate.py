"""Structural netlist generation from the node graph.

Re-implements, with identical ordering and counter semantics:
  - generate_netlist_from_nodes          (src/circuit_analyzer.py:1607-1770)
  - _get_terminal_nodes_relative_to_bbox (src/circuit_analyzer.py:1937-2034)
  - stringify                            (src/circuit_analyzer.py:1909-1927)

These run on host (string/dict work, negligible cost); exact text parity
with the reference is the acceptance criterion, so every tie-break —
node iteration order, per-prefix counters, the UNKNOWN-direction default
swap — is preserved.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from ..core import taxonomy
from ..core.types import BBox, NetlistLine, Node


def _ordered_centroids(
    component: BBox,
    direction: Optional[str],
    reason: Optional[str],
    node1_centroid,
    node2_centroid,
):
    """Pick (primary, secondary) node centroid given the VLM direction.

    Mirrors _get_terminal_nodes_relative_to_bbox exactly, including the
    deliberate default swap for UNKNOWN/non-directional components
    (src/circuit_analyzer.py:1984-1988).
    """
    if not node1_centroid or not node2_centroid:
        return node1_centroid, node2_centroid

    cls = component.class_name
    is_diode = cls in taxonomy.DIODE_CLASSES
    is_voltage = cls in taxonomy.VOLTAGE_CLASSES
    is_current = cls in taxonomy.CURRENT_SOURCE_CLASSES

    reason = reason if reason is not None else "UNKNOWN"
    # direction stays None when the enrichment stage never ran or the
    # class was ineligible (its explicit None write, :2213-2215). The
    # reference treats None DIFFERENTLY from "UNKNOWN": "UNKNOWN" (or a
    # non-directional class) takes the swapped (node2, node1) default at
    # :1986-1988, while any other unhandled value — including None — on a
    # direction-relevant class falls through to the UNSWAPPED
    # (node1, node2) branch at :2027-2030. Verified by the differential
    # harness (tests/test_reference_diff.py); do not coerce None here.

    acts_like_arrow = is_current or (is_voltage and reason == "ARROW")
    acts_like_sign_voltage = is_voltage and reason != "ARROW"

    if direction == "UNKNOWN" or not (acts_like_arrow or acts_like_sign_voltage or is_diode):
        # Default: node2 (typically non-ground) primary (:1987-1988).
        return node2_centroid, node1_centroid

    n1x, n1y = node1_centroid
    n2x, n2y = node2_centroid
    if direction == "UP":
        swapped = n1y < n2y
    elif direction == "DOWN":
        swapped = n1y > n2y
    elif direction == "LEFT":
        swapped = n1x < n2x
    elif direction == "RIGHT":
        swapped = n1x > n2x
    else:
        return node1_centroid, node2_centroid

    if swapped:
        return node2_centroid, node1_centroid
    return node1_centroid, node2_centroid


def generate_netlist_from_nodes(nodes: Sequence[Node]) -> list[NetlistLine]:
    """Emit the valueless structural netlist.

    Per-prefix counters start at 1; components are visited in node order,
    then per-node component order; each persistent uid is emitted once
    (src/circuit_analyzer.py:1609-1658).
    """
    counters: dict[str, int] = {p: 1 for p in set(taxonomy.NETLIST_MAP.values()) if p}
    processed: set[str] = set()
    netlist: list[NetlistLine] = []

    centroids = {n.id: n.centroid for n in nodes}

    for node in nodes:
        for component in node.components:
            cls = component.class_name
            uid = component.persistent_uid
            # None passes through un-coerced: the reference's dicts carry
            # semantic_direction=None for enrichment-ineligible classes
            # and that None selects a DIFFERENT default branch than
            # "UNKNOWN" in the node-ordering helper (see _ordered_centroids).
            direction = component.semantic_direction
            reason = component.semantic_reason

            if not uid:
                continue
            if cls in taxonomy.NETLIST_IGNORE_CLASSES or uid in processed:
                continue
            processed.add(uid)

            other_node_id = None
            for other in nodes:
                if other.id != node.id and any(
                    c.persistent_uid == uid for c in other.components
                ):
                    other_node_id = other.id
                    break

            if cls == "terminal":
                # Still 'terminal' after reclassification → type N to ground
                # (:1670-1677).
                prefix = taxonomy.NETLIST_MAP.get("terminal", "N")
                node_1: object = node.id
                node_2: object = "0"
                value: object = "None"
            else:
                if other_node_id is None:
                    continue  # non-terminal with a single node: skip (:1680-1684)
                prefix = taxonomy.NETLIST_MAP.get(cls, "UN")
                # VLM-driven prefix overrides (:1692-1695)
                if cls in taxonomy.VOLTAGE_CLASSES and reason == "ARROW":
                    prefix = "I"
                elif cls in taxonomy.CURRENT_SOURCE_CLASSES and reason == "SIGN":
                    prefix = "V"
                if not prefix:
                    continue

                cur_c = centroids.get(node.id)
                oth_c = centroids.get(other_node_id)
                if cur_c is None or oth_c is None:
                    n1_id, n2_id = node.id, other_node_id
                else:
                    primary, _ = _ordered_centroids(component, direction, reason, cur_c, oth_c)
                    if primary == cur_c:
                        n1_id, n2_id = node.id, other_node_id
                    else:
                        n1_id, n2_id = other_node_id, node.id

                if cls in ("gnd", "vss"):
                    true_node = n2_id if n1_id == 0 else n1_id
                    node_1, node_2 = true_node, 0
                else:
                    node_1, node_2 = n1_id, n2_id
                value = "None"

            if not prefix:
                continue
            if prefix not in counters:
                counters[prefix] = 1
            num = counters[prefix]
            counters[prefix] += 1

            netlist.append(
                NetlistLine(
                    component_type=prefix,
                    component_num=num,
                    node_1=node_1,
                    node_2=node_2,
                    value=value,
                    class_name=cls,
                    persistent_uid=uid,
                    semantic_direction=component.semantic_direction,
                    semantic_reason=component.semantic_reason,
                    source=dataclasses.replace(component),
                )
            )
    return netlist


def generate_fallback_netlist(bboxes: Sequence[BBox]) -> list[NetlistLine]:
    """Components-only fallback when no nodes were found.

    The reference attempts this with a keyword argument that its own
    function signature does not accept, so its fallback always raises
    (src/analysis_pipeline.py:314 vs src/circuit_analyzer.py:1607). This
    implementation provides the intended behavior: one line per electrical
    component with unknown connectivity.
    """
    counters: dict[str, int] = {p: 1 for p in set(taxonomy.NETLIST_MAP.values()) if p}
    lines: list[NetlistLine] = []
    for bbox in bboxes:
        cls = bbox.class_name
        if cls in taxonomy.NETLIST_IGNORE_CLASSES or cls in ("gnd", "vss"):
            continue
        prefix = taxonomy.NETLIST_MAP.get(cls, "UN")
        if not prefix:
            continue
        if prefix not in counters:
            counters[prefix] = 1
        num = counters[prefix]
        counters[prefix] += 1
        lines.append(
            NetlistLine(
                component_type=prefix,
                component_num=num,
                node_1="?",
                node_2="?",
                value="None",
                class_name=cls,
                persistent_uid=bbox.persistent_uid,
                source=dataclasses.replace(bbox),
            )
        )
    return lines


def stringify_netlist(netlist: Sequence[NetlistLine]) -> str:
    """Join per-line SPICE text (empty lines kept, matching the reference's
    '\\n'.join over stringify_line results, src/analysis_pipeline.py:271)."""
    return "\n".join(line.stringify() for line in netlist)
