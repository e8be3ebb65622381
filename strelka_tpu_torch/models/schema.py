"""JSON-schema validation for model/parameter files.

Reference analog: src/config/validate/validateJsonModelFromSchema.py
with src/config/indelErrorModel/schema/indelErrorModelSchema.json and
src/config/empiricalVariantScoring/schema/empiricalScoringModelSchema.json.
The schemas here are written fresh against the same documented file
formats (draft-04 semantics via the jsonschema package).
"""
from __future__ import annotations

import json

INDEL_ERROR_MODEL_SCHEMA = {
    "type": "object",
    "required": ["sample"],
    "properties": {
        "sample": {
            "type": "array",
            "minItems": 1,
            "items": {
                "type": "object",
                "required": ["sampleName", "motif"],
                "properties": {
                    "isStatic": {"type": "boolean"},
                    "sampleName": {"type": "string"},
                    "motif": {
                        "type": "array",
                        "minItems": 1,
                        "items": {
                            "type": "object",
                            "required": ["indelRate", "noisyLocusRate",
                                         "repeatCount",
                                         "repeatPatternSize"],
                            "properties": {
                                "indelRate": {"type": "number",
                                              "minimum": 0, "maximum": 1},
                                "noisyLocusRate": {"type": "number",
                                                   "minimum": 0,
                                                   "maximum": 1},
                                "repeatCount": {"type": "integer",
                                                "minimum": 1},
                                "repeatPatternSize": {"type": "integer",
                                                      "minimum": 1},
                            },
                        },
                    },
                },
            },
        },
    },
}

_EVS_MODEL = {
    "type": "object",
    "required": ["Features", "Model"],
    "properties": {
        "Features": {"type": "array", "minItems": 1,
                     "items": {"type": "string"}},
        "Model": {"type": "array", "minItems": 1},
        "Calibration": {
            "type": "object",
            "properties": {"Power": {"type": "number"},
                           "Scale": {"type": "number"}},
        },
        "FilterCutoff": {"type": "number"},
        "ModelType": {"type": "string"},
        "Date": {"type": "string"},
    },
}

EVS_SCHEMA = {
    "type": "object",
    "required": ["CalibrationModels"],
    "properties": {
        "CalibrationModels": {
            "type": "object",
            "minProperties": 1,
            "patternProperties": {
                "^(Germline|RNAseq|Somatic)$": {
                    "type": "object",
                    "minProperties": 1,
                    "patternProperties": {"^(SNV|INDEL)$": _EVS_MODEL},
                    "additionalProperties": False,
                },
            },
            "additionalProperties": False,
        },
    },
    "additionalProperties": False,
}

THETA_SCHEMA = {
    "type": "object",
    "required": ["thetas"],
    "properties": {
        "thetas": {
            "type": "array",
            "minItems": 1,
            "items": {
                "type": "object",
                "required": ["repeatPatternSize", "theta"],
                "properties": {
                    "repeatPatternSize": {"type": "integer", "minimum": 1},
                    "theta": {"type": "array", "minItems": 1,
                              "items": {"type": "number", "minimum": 0}},
                },
            },
        },
    },
}


class ModelValidationError(ValueError):
    pass


def validate_model(doc: dict, kind: str, source: str = "<model>") -> None:
    """Validate a parsed model document; kind in
    {indel-error, evs, theta}. Raises ModelValidationError with the
    failing JSON path."""
    schema = {"indel-error": INDEL_ERROR_MODEL_SCHEMA,
              "evs": EVS_SCHEMA,
              "theta": THETA_SCHEMA}.get(kind)
    if schema is None:
        raise ValueError(f"unknown model kind {kind!r}")
    try:
        import jsonschema
    except ImportError:  # environment without jsonschema: skip
        return
    try:
        jsonschema.validate(doc, schema)
    except jsonschema.ValidationError as e:
        path = "/".join(str(p) for p in e.absolute_path) or "<root>"
        raise ModelValidationError(
            f"{source}: invalid {kind} model at {path}: {e.message}"
        ) from None


def validate_model_file(path: str, kind: str) -> None:
    with open(path) as f:
        try:
            doc = json.load(f)
        except json.JSONDecodeError as e:
            raise ModelValidationError(f"{path}: not valid JSON: {e}") \
                from None
    validate_model(doc, kind, source=path)
