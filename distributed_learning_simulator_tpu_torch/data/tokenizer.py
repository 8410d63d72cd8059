"""The ``dataset_kwargs.tokenizer`` check (the port's copy of
``resolve_tokenizer_type`` from the JAX package's ``data/tokenizer.py``).

The synthetic text datasets are already token ids, so the port keeps only
the validation: unknown tokenizer types are refused rather than dropped.
The vocab-file tokenizer itself serves real data, which is not ported yet.
"""

from ..utils.logging import get_logger

#: tokenizer types the config surface accepts (``dataset_kwargs.tokenizer.type``)
KNOWN_TOKENIZER_TYPES = ("spacy", "regex")


def resolve_tokenizer_type(
    tokenizer_kwargs: dict | str | None, metadata: dict | None = None
) -> str | None:
    """Validate ``dataset_kwargs.tokenizer`` and name the tokenizer that
    serves it: ``spacy`` resolves to ``regex`` unless the dataset carries
    a spacy-tokenized export (metadata ``tokenizer_type``)."""
    if not tokenizer_kwargs:
        return None
    if isinstance(tokenizer_kwargs, str):  # shorthand: `tokenizer: spacy`
        tokenizer_kwargs = {"type": tokenizer_kwargs}
    requested = str(tokenizer_kwargs.get("type", "regex")).lower()
    if requested not in KNOWN_TOKENIZER_TYPES:
        raise ValueError(
            f"dataset_kwargs.tokenizer.type must be one of "
            f"{KNOWN_TOKENIZER_TYPES}, got {requested!r}"
        )
    if requested == "spacy" and (metadata or {}).get("tokenizer_type") != "spacy":
        get_logger().warning(
            "tokenizer.type=spacy requested but the dataset carries no "
            "spacy-tokenized export; using the deterministic regex tokenizer"
        )
        return "regex"
    return requested
