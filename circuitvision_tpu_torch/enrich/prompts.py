"""The prompts of the black-box VLM value pass, string for string the JAX
package's `enrich/prompts.py` (from the reference):

- the component taxonomy descriptions and the stage-2 extraction prompt
  (src/utils.py:27-99);
- the per-class direction prompts (src/circuit_analyzer.py:2051-2097).
"""

COMPONENTS_DICT = {
    "gnd": "Ground: A reference point in an electrical circuit. Its value is None.",
    "voltage.ac": "AC Voltage source. If its value is written in phasor, format it as magnitude:phase.",
    "voltage.dc": "DC Voltage source. Its polarity is important for circuit analysis.",
    "voltage.battery": "Battery Voltage source. Its polarity is important for circuit analysis.",
    "resistor": "Resistor: A passive component.",
    "voltage.dependent": "Voltage-Dependent Source: A voltage source whose output voltage depends on another voltage or current in the circuit. Its polarity is important.",
    "current.dc": "DC Current: Direct current, where the current flows in one direction consistently. Its direction of flow is important.",
    "current.dependent": "Current-Dependent Source: A current source whose output current depends on another current or voltage in the circuit. Its direction of flow is important.",
    "capacitor": "Capacitor: A passive component.",
    "inductor": "Inductor: A passive component.",
    "diode": "Diode: A semiconductor device that primarily conducts current in one direction. Its orientation is important.",
}

LABELS_PROMPT = """
You are an expert electrical engineering assistant. Your task is to analyze an image of a circuit schematic.
In the image, electrical components are marked with red ID numbers.
Your goal is to identify these components and their values.

Output your findings as a Python list of dictionaries. Each dictionary in the list represents one component.
Strictly adhere to the following format for each dictionary:
[
  {
    "id": "string_id_from_image",
    "class": "component_class_name",
    "value": "component_value_string_or_null"
  }
  // ... more components can follow
]

Example of a single component entry:
{
    "id": "1",
    "class": "voltage.ac",
    "value": "10:30"
}
{
    "id": "2",
    "class": "resistor",
    "value": "10k"
}


Key Instructions for each field in the dictionary:

1.  **`id` (String):**
    *   This MUST be the red number shown next to the component in the image.
    *   The value for 'id' MUST be a STRING (e.g., "1", "12", "27").

2.  **`class` (String):**
    *   Use ONLY the class names provided as keys in the 'Component Classes and Descriptions' section below (e.g., 'resistor', 'voltage.ac').
    *   Do not invent new class names.

3.  **`value` (String or null/None):**
    *   If a numerical value is present:
        *   Represent it as a STRING.
        *   Include metric prefixes directly attached to the number if present (e.g., "10k", "2.2M", "100m", "0.5u", "22n", "47p"). NO SPACE between number and prefix.
        *   Do NOT include the base unit (like Ω, F, V, A). Just the number and prefix.
        *   For AC voltage sources (`voltage.ac`), if a phasor is given, format the value string as "magnitude:angle_in_degrees" (e.g., "120:30" for 120V at 30 degrees, "10:0").
        *   For complex impedance values (e.g., for capacitors or inductors if given in ohms), use the format "R+jX" or "R-jX" as a string (e.g., "5+j3.14", "100-j50").
    *   If the value is a variable name or an expression (e.g., "V_in", "R_load", "X1", "35*V_2"), use that variable name or expression as a STRING.
    *   If no value is explicitly written next to the component on the schematic, or if it's unclear (e.g., a question mark "?"), the value MUST be `null` (if generating JSON) or `None` (if generating a Python literal string).

General Instructions:

*   Identify ONLY the components that have a clear red ID number next to them.
*   The 'id' in your output dictionary MUST correspond to this red number.
*   If a component in the image is ambiguous, its ID is unclear, or it cannot be confidently classified using the provided list, DO NOT include it in the output list.
*   Ensure the entire output is a valid Python list of dictionaries string, parsable by `ast.literal_eval`, or a valid JSON array of objects.

Component Classes and Descriptions:
""" + str(COMPONENTS_DICT)

VOLTAGE_DIRECTION_PROMPT = """Analyze this image.

Focus on identifying the following key elements:
1. The + (plus) and - (minus) symbols or arrow if present
2. Their relative positions in the image (top, bottom, left, right)

Return a JSON object with these fields:
- symbol_positions: Describe the exact locations of + and - symbols. If there's an arrow instead, write "ARROW"
- direction: ONE of [UP, DOWN, LEFT, RIGHT] determined by these rules:
  * For +/- symbols:
    - If + is at bottom → direction: "UP"
    - If + is at top → direction: "DOWN"
    - If + is at left → direction: "RIGHT"
    - If + is at right → direction: "LEFT"
  * For voltage arrow:
    - Arrow pointing up → direction: "UP"
    - Arrow pointing down → direction: "DOWN"
    - Arrow pointing left → direction: "LEFT"
    - Arrow pointing right → direction: "RIGHT"
- reason: ONE of ["SIGN", "ARROW"] indicating if direction was based on +/- symbols or an arrow.

Example responses:
{"symbol_positions": "+ at bottom, - at top", "direction": "UP", "reason": "SIGN"}
{"symbol_positions": "ARROW", "direction": "RIGHT", "reason": "ARROW"}
"""

DIODE_DIRECTION_PROMPT = """Analyze this image.

A diode symbol consists of:
1. A triangle (▶) pointing in the direction of current flow
2. A bar (|) perpendicular to the direction of flow

Focus on identifying:
1. The orientation of the triangle-bar symbol
2. The direction the triangle is pointing (this is the direction of current flow)

Return a JSON object with ONE field:
- direction: ONE of [UP, DOWN, LEFT, RIGHT] based on where the triangle points:
  * Triangle points up → direction: "UP"
  * Triangle points down → direction: "DOWN"
  * Triangle points left → direction: "LEFT"
  * Triangle points right → direction: "RIGHT"

Example responses:
{"direction": "RIGHT"}  // For triangle pointing right →
{"direction": "UP"}     // For triangle pointing up ↑
"""
