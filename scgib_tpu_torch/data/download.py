"""Dataset acquisition: download the raw distributions the readers parse.

The reference acquires every dataset through PyG/OGB's downloaders
(``exp_moleculenetBACE_BBBP.py:219-224`` MoleculeNet, ``exp_molhiv.py:223``
OGB, ``exp_pcqm4mv2.py:260-268`` OGB-LSC, ``exp_pep_func_5.py:251-257``
LRGB, ``exp_tudataset.py`` TUDataset, ``molecules.py:18-94`` ZINC).  This
module fetches the SAME upstream artifacts those libraries fetch — the
URLs below are the ones inside PyG ``MoleculeNet.names`` /
``ogb.utils.url`` / the LRGB + benchmarking-gnns repos — and lands them in
exactly the on-disk layout :mod:`.molnet` / :mod:`.sdf` /
:mod:`.tudataset` / :mod:`.zinc` expect, so

    python -m scgib_tpu_torch.cli download --dataset BACE --root data/molnet
    python -m scgib_tpu_torch.cli finetune --dataset BACE --molnet_root data/molnet

is the full chain.  Every helper takes ``base_url`` so the whole path is
testable against a local HTTP server without network egress
(tests/test_download.py).

The port's own copy of ``scgib_tpu/data/download.py`` (NumPy only), held to
it by ``tests/test_torch_data.py``.
"""

from __future__ import annotations

import os
import shutil
import tarfile
import urllib.error
import urllib.request
import zipfile
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

# ---------------------------------------------------------------------------
# Registry: dataset name -> files to fetch + how to unpack them
# ---------------------------------------------------------------------------

_DEEPCHEM = "https://deepchemdata.s3-us-west-1.amazonaws.com/datasets"
_OGB_GPP = "http://snap.stanford.edu/ogb/data/graphproppred/csv_mol_download"
_OGB_LSC = "https://dgl-data.s3-accelerate.amazonaws.com/dataset/OGB-LSC"
_TUD = "https://www.chrsmrrs.com/graphkerneldatasets"
# LRGB tables (github.com/vijaydwivedi75/lrgb download URLs)
_LRGB_FUNC = ("https://www.dropbox.com/s/ol2v01usvaxbsr8/"
              "peptide_multi_class_dataset.csv.gz?dl=1")
_LRGB_STRUCT = ("https://www.dropbox.com/s/464u3303eu2u4zp/"
                "peptide_structure_dataset.csv.gz?dl=1")
# benchmarking-gnns ZINC pickles (molecules.py:18-94 consumes these)
_ZINC = "https://data.dgl.ai/dataset/benchmarking-gnns/ZINC.zip"


@dataclass(frozen=True)
class FileSpec:
    """One artifact: fetch ``url`` to ``dest`` (relative to the dataset
    root), then optionally unpack.  ``extract``: None | 'zip' | 'tar' |
    'flatten-zip' (zip whose single top-level dir is stripped)."""

    url: str
    dest: str
    extract: Optional[str] = None
    # post-extract renames {archive path -> desired relative path}
    renames: Dict[str, str] = field(default_factory=dict)


# MoleculeNet: <root>/<name>/raw/<csv> (PyG MoleculeNet layout, the first
# layout load_moleculenet searches)
_MOLNET_FILES = {
    "BACE": "bace.csv", "BBBP": "BBBP.csv", "HIV": "HIV.csv",
    "Tox21": "tox21.csv.gz", "ToxCast": "toxcast_data.csv.gz",
    "SIDER": "sider.csv.gz", "ClinTox": "clintox.csv.gz",
    "MUV": "muv.csv.gz", "ESOL": "delaney-processed.csv",
    "FreeSolv": "SAMPL.csv", "Lipo": "Lipophilicity.csv",
}

REGISTRY: Dict[str, List[FileSpec]] = {
    name: [FileSpec(f"{_DEEPCHEM}/{fname}", f"{name}/raw/{fname}")]
    for name, fname in _MOLNET_FILES.items()
}
REGISTRY.update({
    # OGB zips unpack to <name>/{raw,mapping,split}/...; load_ogb_graphs
    # reads <root>/<name>/raw
    "molhiv": [FileSpec(f"{_OGB_GPP}/hiv.zip", "hiv.zip", extract="zip")],
    "molpcba": [FileSpec(f"{_OGB_GPP}/pcba.zip", "pcba.zip",
                         extract="zip")],
    # pcqm4m-v2.zip unpacks pcqm4m-v2/raw/data.csv.gz — a layout
    # load_pcqm4mv2 searches directly
    "PCQM4Mv2": [FileSpec(f"{_OGB_LSC}/pcqm4m-v2.zip", "pcqm4m-v2.zip",
                          extract="zip")],
    # QM9: gdb9.sdf + gdb9.sdf.csv (load_qm9/sdf.py layout)
    "QM9": [FileSpec(f"{_DEEPCHEM}/gdb9.tar.gz", "gdb9.tar.gz",
                     extract="tar")],
    "Peptides-func": [FileSpec(_LRGB_FUNC,
                               "peptide_multi_class_dataset.csv.gz")],
    "Peptides-struct": [FileSpec(_LRGB_STRUCT,
                                 "peptide_structure_dataset.csv.gz")],
    # ZINC.zip carries {train,val,test}.{pickle,index}; zinc.py reads
    # them at the root, so strip the archive's top-level dir
    "ZINC": [FileSpec(_ZINC, "ZINC.zip", extract="flatten-zip")],
})
for _t in ("Mutagenicity", "NCI1", "NCI109", "ENZYMES", "PROTEINS"):
    REGISTRY[_t] = [FileSpec(f"{_TUD}/{_t}.zip", f"{_t}.zip",
                             extract="zip")]


# ---------------------------------------------------------------------------
# Fetch + unpack machinery
# ---------------------------------------------------------------------------

def _fetch(url: str, dest: str, retries: int = 3,
           timeout: float = 60.0) -> None:
    """Stream ``url`` to ``dest`` atomically (.part + rename)."""
    os.makedirs(os.path.dirname(dest) or ".", exist_ok=True)
    part = dest + ".part"
    last: Optional[Exception] = None
    for attempt in range(retries):
        try:
            req = urllib.request.Request(
                url, headers={"User-Agent": "scgib-tpu/1.0"})
            with urllib.request.urlopen(req, timeout=timeout) as r, \
                    open(part, "wb") as f:
                shutil.copyfileobj(r, f, length=1 << 20)
            os.replace(part, dest)
            return
        except (urllib.error.URLError, OSError) as e:  # retry then give up
            last = e
            if os.path.exists(part):
                os.remove(part)
    raise RuntimeError(f"download failed after {retries} tries: {url}: "
                       f"{last}")


def _safe_rel(member: str) -> str:
    """Sanitize an archive member path for manual extraction.

    ``zipfile.extractall`` strips ``..``/absolute components itself; this
    manual writer must do the same or a crafted entry like
    ``top/../../escape.txt`` writes outside the extraction root (zip-slip
    via a malicious --base_url mirror or compromised upstream)."""
    parts = [p for p in member.replace("\\", "/").split("/")
             if p not in ("", os.curdir, os.pardir)
             and not (len(p) == 2 and p[1] == ":")]   # drive letters
    if not parts:
        raise ValueError(f"unsafe archive member path: {member!r}")
    return os.path.join(*parts)


def _extract(archive: str, root: str, mode: str) -> None:
    if mode == "tar":
        with tarfile.open(archive) as tf:
            tf.extractall(root, filter="data")
        return
    with zipfile.ZipFile(archive) as zf:
        if mode == "flatten-zip":
            # strip a single shared top-level directory if present
            names = [n for n in zf.namelist() if not n.endswith("/")]
            tops = {n.split("/", 1)[0] for n in names if "/" in n}
            strip = len(tops) == 1 and all("/" in n for n in names)
            for n in names:
                rel = _safe_rel(n.split("/", 1)[1] if strip else n)
                out = os.path.join(root, rel)
                os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
                with zf.open(n) as src, open(out, "wb") as dst:
                    shutil.copyfileobj(src, dst)
        else:
            zf.extractall(root)


def _rebase(url: str, base_url: Optional[str]) -> str:
    """Point ``url`` at a mirror: keep only the filename (dropbox-style
    ``?dl=1`` suffixes stripped)."""
    if base_url is None:
        return url
    fname = url.rsplit("/", 1)[-1].split("?", 1)[0]
    return f"{base_url.rstrip('/')}/{fname}"


def download_dataset(name: str, root: str,
                     base_url: Optional[str] = None,
                     force: bool = False) -> List[str]:
    """Fetch + unpack every artifact of ``name`` under ``root``.

    Idempotent: files already present are kept unless ``force``.  Returns
    the list of paths written.  ``base_url`` redirects every fetch to a
    mirror (used by the localhost round-trip test, and usable for
    institutional mirrors in air-gapped setups).
    """
    if name not in REGISTRY:
        raise KeyError(
            f"unknown dataset {name!r}; known: {sorted(REGISTRY)}")
    written: List[str] = []
    for spec in REGISTRY[name]:
        dest = os.path.join(root, spec.dest)
        if force or not os.path.exists(dest):
            _fetch(_rebase(spec.url, base_url), dest)
        written.append(dest)
        if spec.extract:
            _extract(dest, root, spec.extract)
        for src_rel, dst_rel in spec.renames.items():
            s, d = os.path.join(root, src_rel), os.path.join(root, dst_rel)
            if os.path.exists(s):
                os.makedirs(os.path.dirname(d) or ".", exist_ok=True)
                os.replace(s, d)
                written.append(d)
    return written


def download_all(names: Sequence[str], root: str,
                 base_url: Optional[str] = None) -> None:
    for n in names:
        download_dataset(n, root, base_url=base_url)
