"""NCBI Entrez genbank:// resolution for CSV libraries.

Replaces the reference's Biopython-Entrez path (reference: nimble/remote.py)
with a stdlib urllib implementation (Biopython is not available here). Uses
NCBI_EMAIL / NCBI_API_KEY env vars like the reference. Network access is
required only when a library CSV actually contains genbank:// links.
"""
from __future__ import annotations

import json
import os
import urllib.parse
import urllib.request
from typing import List, Tuple

_EUTILS = "https://eutils.ncbi.nlm.nih.gov/entrez/eutils"


def _common_params() -> dict:
    params = {"tool": "nimble_tpu"}
    email = os.environ.get("NCBI_EMAIL")
    api_key = os.environ.get("NCBI_API_KEY")
    if email:
        params["email"] = email
    if api_key:
        params["api_key"] = api_key
    return params


def _get(url: str, params: dict) -> bytes:
    query = urllib.parse.urlencode(params)
    with urllib.request.urlopen(f"{url}?{query}", timeout=60) as resp:
        return resp.read()


def get_ids(term: str) -> List[str]:
    """esearch the nucleotide db for a term (reference: remote.py:44-49)."""
    params = dict(_common_params(), db="nucleotide", term=term, retmode="json")
    record = json.loads(_get(f"{_EUTILS}/esearch.fcgi", params))
    return list(record.get("esearchresult", {}).get("idlist", []))


def fetch_sequence(ids: List[str], string_id: str, subset: str | None) -> Tuple[int, str]:
    """efetch a FASTA record, optionally slicing [start:end]
    (reference: remote.py:12-41)."""
    if len(ids) != 1:
        raise ValueError(
            f"attempt to fetch sequence with {'multiple' if ids else 'no'} ids: {string_id}"
        )
    params = dict(
        _common_params(), db="nucleotide", id=ids[0], retmode="text", rettype="fasta"
    )
    record = _get(f"{_EUTILS}/efetch.fcgi", params).decode()
    lines = record.splitlines()
    seq = "".join(line for line in lines[1:] if line and line[0] != ">")
    if subset:
        start, end = subset.split("-")
        seq = seq[int(start) : int(end)]
    return len(seq), seq


def resolve_genbank(raw: str) -> Tuple[int, str]:
    """Resolve a `genbank://<term>[:<start-end>]` cell to (nt_length, seq)."""
    parts = raw.split(":")
    subset = parts[2] if len(parts) == 3 else None
    term = parts[1].replace("//", "")
    ids = get_ids(term)
    return fetch_sequence(ids, raw, subset)
