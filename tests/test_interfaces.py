"""Protocol conformance of the real implementations + FsPaths registry."""

import os

from fspann import interfaces as I
from fspann.crypto.keys import KeyManager
from fspann.crypto.rotation import KeyRotationService
from fspann.index.service import PartitionedIndex
from fspann.config import SystemConfig
from fspann.store.metadata import MetadataLog
from fspann.store.point_store import PointStore
from fspann.store.sharded_store import ShardedPointStore
from fspann.utils.paths import FsPaths


def test_protocol_conformance(tmp_path):
    km = KeyManager(str(tmp_path / "ks"))
    store = PointStore(str(tmp_path / "db"), km, dim=4)
    sharded = ShardedPointStore(str(tmp_path / "db2"), km, dim=4,
                                num_shards=2)
    rot = KeyRotationService(km, store)
    idx = PartitionedIndex(SystemConfig().validate(), dim=4)
    meta = MetadataLog(str(tmp_path / "m.log"))
    assert isinstance(idx, I.IndexService)
    assert isinstance(rot, I.KeyLifeCycleService)
    assert isinstance(rot, I.SelectiveReencryptor)
    assert isinstance(store, I.PointStoreProtocol)
    assert isinstance(store, I.StorageSizer)
    assert isinstance(sharded, I.PointStoreProtocol)
    assert isinstance(meta, I.MetadataManager)
    store.close()
    sharded.close()


def test_fspaths_defaults_and_env(tmp_path, monkeypatch):
    p = FsPaths(str(tmp_path / "base"))
    assert p.points_dir.endswith("points")
    assert p.keystore_file.endswith("keystore.blob")
    monkeypatch.setenv("FSPANN_POINTS_DIR", "/elsewhere/pts")
    assert FsPaths(str(tmp_path)).points_dir == "/elsewhere/pts"
    monkeypatch.setenv("FSPANN_BASE_DIR", str(tmp_path / "envbase"))
    assert FsPaths().base_dir == str(tmp_path / "envbase")
    p2 = FsPaths(str(tmp_path / "made")).ensure()
    assert os.path.isdir(p2.base_dir)
