"""VLM merge + renumber pass over the structural netlist.

Counterpart of the JAX package's `netlist/fix.py`, which re-implements
fix_netlist (src/circuit_analyzer.py:1772-1907) with identical
merge rules:

  Pass 1 — per line, map persistent_uid → visual id via the enumerated
  bboxes; merge the matching VLM {id, class, value} item:
    * a VLM value only fills a missing ("None") value;
    * for independent V/I sources, a purely-alphabetic VLM value other than
      'ac' is invalidated to None;
    * a None VLM value *clears* an existing value on V/I sources;
    * class and component_type are always overwritten by the VLM class;
    * VLM class 'gnd' forces node_2 = 0.
  Sort — by visual id (None/invalid ids last, tie-broken by uid).
  Pass 2 — renumber sequentially per final component_type.
"""
from __future__ import annotations

from typing import Sequence

from ..core import taxonomy
from ..core.types import BBox, NetlistLine


def fix_netlist(
    netlist: list[NetlistLine],
    vlm_out: Sequence[dict],
    enum_bboxes: Sequence[BBox],
) -> list[NetlistLine]:
    """Merge VLM output into the netlist in place and renumber. Returns it."""
    uid_to_visual = {b.persistent_uid: b.visual_id for b in enum_bboxes}

    # ---- Pass 1: merge VLM data ----------------------------------------
    for line in netlist:
        uid = line.persistent_uid
        if not uid:
            continue
        visual_id = uid_to_visual.get(uid)
        line.visual_id = visual_id
        if visual_id is None:
            if not line.class_name:
                line.class_name = "unknown"
            if not line.component_type:
                line.component_type = taxonomy.NETLIST_MAP.get(line.class_name, "UN")
            continue

        for item in vlm_out:
            if str(item.get("id")) != str(visual_id):
                continue
            vlm_class = item.get("class")
            if not vlm_class:
                if not line.class_name:
                    line.class_name = "unknown"
                if not line.component_type:
                    line.component_type = taxonomy.NETLIST_MAP.get(line.class_name, "UN")
                break

            vlm_value = item.get("value")
            effective_value = vlm_value
            prospective_type = taxonomy.NETLIST_MAP.get(vlm_class, "UN")

            if prospective_type in ("V", "I") and isinstance(vlm_value, str):
                try:
                    float(vlm_value)
                except ValueError:
                    if vlm_value.isalpha() and vlm_value.lower() != "ac":
                        effective_value = None

            current = line.value
            current_is_none = current is None or str(current).strip().lower() == "none"
            if current_is_none:
                line.value = effective_value
            elif effective_value is None and prospective_type in ("V", "I"):
                line.value = None

            line.class_name = vlm_class
            line.component_type = prospective_type
            if vlm_class == "gnd":
                line.node_2 = 0
            break

    # ---- Sort by visual id (:1859-1871) ---------------------------------
    def sort_key(item: NetlistLine):
        vid = item.visual_id
        if vid is None:
            return (float("inf"), item.persistent_uid)
        try:
            return (int(vid), item.persistent_uid)
        except (ValueError, TypeError):
            return (float("inf"), item.persistent_uid)

    netlist.sort(key=sort_key)

    # ---- Pass 2: renumber per final type (:1877-1907) -------------------
    counters: dict[str, int] = {p: 1 for p in set(taxonomy.NETLIST_MAP.values()) if p}
    counters.setdefault("UN", 1)
    for line in netlist:
        # An unexpected type draws from the 'UN' counter but the line keeps
        # its own type string (matching the reference, which only reassigns
        # the local counter key, :1887-1892).
        counter_key = line.component_type
        if not counter_key or counter_key not in counters:
            counter_key = "UN"  # empty types also draw from 'UN' (:1887-1899)
        line.component_num = counters[counter_key]
        counters[counter_key] += 1
    return netlist
