"""6-DOF pose container.

Parity source: reference `language_table/environments/utils/pose3d.py:40-67`
(scipy Rotation + translation, vec7, serialize/deserialize, shallow asdict).
"""

import dataclasses

import numpy as np
from scipy.spatial import transform


@dataclasses.dataclass
class Pose3d:
    """Rotation + translation."""

    rotation: transform.Rotation
    translation: np.ndarray

    @property
    def vec7(self):
        """[x, y, z, qx, qy, qz, qw]."""
        return np.concatenate([self.translation, self.rotation.as_quat()])

    @property
    def matrix(self):
        """4x4 homogeneous transform."""
        m = np.eye(4)
        m[:3, :3] = self.rotation.as_matrix()
        m[:3, 3] = np.asarray(self.translation)
        return m

    def multiply(self, other: "Pose3d") -> "Pose3d":
        return Pose3d.from_matrix(self.matrix @ other.matrix)

    def inverse(self) -> "Pose3d":
        inv_rot = self.rotation.inv()
        return Pose3d(
            rotation=inv_rot,
            translation=-inv_rot.apply(self.translation),
        )

    @staticmethod
    def from_matrix(m: np.ndarray) -> "Pose3d":
        return Pose3d(
            rotation=transform.Rotation.from_matrix(m[:3, :3]),
            translation=np.array(m[:3, 3]),
        )

    def asdict(self):
        # Shallow copy (tf.data chokes on deepcopy'd Rotations,
        # reference pose3d.py:27-37).
        return {
            f.name: getattr(self, f.name)
            for f in dataclasses.fields(self)
        }

    def serialize(self):
        return {
            "rotation": self.rotation.as_quat().tolist(),
            "translation": np.asarray(self.translation).tolist(),
        }

    @staticmethod
    def deserialize(data):
        return Pose3d(
            rotation=transform.Rotation.from_quat(data["rotation"]),
            translation=np.array(data["translation"]),
        )

    def __eq__(self, other):
        return np.array_equal(
            self.rotation.as_quat(), other.rotation.as_quat()
        ) and np.array_equal(self.translation, other.translation)

    def __ne__(self, other):
        return not self.__eq__(other)
