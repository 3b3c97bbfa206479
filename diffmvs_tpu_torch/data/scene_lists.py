"""Benchmark scene splits as code constants, and a generator for the
lists/*.txt files the --trainlist / --testlist flags read.

A copy of diffmvs_tpu/data/scene_lists.py (the port imports nothing of
the JAX package): the MVSNet DTU partition, the BlendedMVS training and
validation scan hashes, the Tanks&Temples intermediate / advanced scene
names and the ETH3D high-res train / test scenes, as the reference ships
them in lists/.

    python -m diffmvs_tpu_torch.data.scene_lists [outdir]
"""

from __future__ import annotations

import os
import sys

DTU_TRAIN = [f"scan{i}" for i in (
    2, 6, 7, 8, 14, 16, 18, 19, 20, 22, 30, 31, 36, 39, 41, 42, 44, 45, 46,
    47, 50, 51, 52, 53, 55, 57, 58, 60, 61, 63, 64, 65, 68, 69, 70, 71, 72,
    74, 76, 83, 84, 85, 87, 88, 89, 90, 91, 92, 93, 94, 95, 96, 97, 98, 99,
    100, 101, 102, 103, 104, 105, 107, 108, 109, 111, 112, 113, 115, 116,
    119, 120, 121, 122, 123, 124, 125, 126, 127, 128)]

DTU_VAL = [f"scan{i}" for i in (
    3, 5, 17, 21, 28, 35, 37, 38, 40, 43, 56, 59, 66, 67, 82, 86, 106, 117)]

DTU_TEST = [f"scan{i}" for i in (
    1, 4, 9, 10, 11, 12, 13, 15, 23, 24, 29, 32, 33, 34, 48, 49, 62, 75, 77,
    110, 114, 118)]

TANK_INTERMEDIATE = [f"intermediate/{s}" for s in (
    "Family", "Francis", "Horse", "Lighthouse", "M60", "Panther",
    "Playground", "Train")]

TANK_ADVANCED = [f"advanced/{s}" for s in (
    "Auditorium", "Ballroom", "Courtroom", "Museum", "Palace", "Temple")]

ETH3D_TRAIN = [
    "courtyard", "delivery_area", "electro", "facade", "kicker", "meadow",
    "office", "pipes", "playground", "relief", "relief_2", "terrace",
    "terrains"]

ETH3D_TEST = [
    "botanical_garden", "boulders", "bridge", "door", "exhibition_hall",
    "lecture_room", "living_room", "lounge", "observatory", "old_computer",
    "statue", "terrace_2"]

BLEND_TRAIN = """5c1f33f1d33e1f2e4aa6dda4 5bfe5ae0fe0ea555e6a969ca
5bff3c5cfe0ea555e6bcbf3a 58eaf1513353456af3a1682a 5bfc9d5aec61ca1dd69132a2
5bf18642c50e6f7f8bdbd492 5bf26cbbd43923194854b270 5bf17c0fd439231948355385
5be3ae47f44e235bdbbc9771 5be3a5fb8cfdd56947f6b67c 5bbb6eb2ea1cfa39f1af7e0c
5ba75d79d76ffa2c86cf2f05 5bb7a08aea1cfa39f1a947ab 5b864d850d072a699b32f4ae
5b6eff8b67b396324c5b2672 5b6e716d67b396324c2d77cb 5b69cc0cb44b61786eb959bf
5b62647143840965efc0dbde 5b60fa0c764f146feef84df0 5b558a928bbfb62204e77ba2
5b271079e0878c3816dacca4 5b08286b2775267d5b0634ba 5afacb69ab00705d0cefdd5b
5af28cea59bc705737003253 5af02e904c8216544b4ab5a2 5aa515e613d42d091d29d300
5c34529873a8df509ae57b58 5c34300a73a8df509add216d 5c1af2e2bee9a723c963d019
5c1892f726173c3a09ea9aeb 5c0d13b795da9479e12e2ee9 5c062d84a96e33018ff6f0a6
5bfd0f32ec61ca1dd69dc77b 5bf21799d43923194842c001 5bf3a82cd439231948877aed
5bf03590d4392319481971dc 5beb6e66abd34c35e18e66b9 5be883a4f98cee15019d5b83
5be47bf9b18881428d8fbc1d 5bcf979a6d5f586b95c258cd 5bce7ac9ca24970bce4934b6
5bb8a49aea1cfa39f1aa7f75 5b78e57afc8fcf6781d0c3ba 5b21e18c58e2823a67a10dd8
5b22269758e2823a67a3bd03 5b192eb2170cf166458ff886 5ae2e9c5fe405c5076abc6b2
5adc6bd52430a05ecb2ffb85 5ab8b8e029f5351f7f2ccf59 5abc2506b53b042ead637d86
5ab85f1dac4291329b17cb50 5a969eea91dfc339a9a3ad2c 5a8aa0fab18050187cbe060e
5a7d3db14989e929563eb153 5a69c47d0d5d0a7f3b2e9752 5a618c72784780334bc1972d
5a6464143d809f1d8208c43c 5a588a8193ac3d233f77fbca 5a57542f333d180827dfc132
5a572fd9fc597b0478a81d14 5a563183425d0f5186314855 5a4a38dad38c8a075495b5d2
5a48d4b2c7dab83a7d7b9851 5a489fb1c7dab83a7d7b1070 5a48ba95c7dab83a7d7b44ed
5a3ca9cb270f0e3f14d0eddb 5a3cb4e4270f0e3f14d12f43 5a3f4aba5889373fbbc5d3b5
5a0271884e62597cdee0d0eb 59e864b2a9e91f2c5529325f 599aa591d5b41f366fed0d58
59350ca084b7f26bf5ce6eb8 59338e76772c3e6384afbb15 5c20ca3a0843bc542d94e3e2
5c1dbf200843bc542d8ef8c4 5c1b1500bee9a723c96c3e78 5bea87f4abd34c35e1860ab5
5c2b3ed5e611832e8aed46bf 57f8d9bbe73f6760f10e916a 5bf7d63575c26f32dbf7413b
5be4ab93870d330ff2dce134 5bd43b4ba6b28b1ee86b92dd 5bccd6beca24970bce448134
5bc5f0e896b66a2cd8f9bd36 5b908d3dc6ab78485f3d24a9 5b2c67b5e0878c381608b8d8
5b4933abf2b5f44e95de482a 5b3b353d8d46a939f93524b9 5acf8ca0f3d8a750097e4b15
5ab8713ba3799a1d138bd69a 5aa235f64a17b335eeaf9609 5aa0f9d7a9efce63548c69a1
5a8315f624b8e938486e0bd8 5a48c4e9c7dab83a7d7b5cc7 59ecfd02e225f6492d20fcc9
59f87d0bfa6280566fb38c9a 59f363a8b45be22330016cad 59f70ab1e5c5d366af29bf3e
59e75a2ca9e91f2c5526005d 5947719bf1b45630bd096665 5947b62af1b45630bd0c2a02
59056e6760bb961de55f3501 58f7f7299f5b5647873cb110 58cf4771d0f5fb221defe6da
58d36897f387231e6c929903 58c4bb4f4a69c55606122be4""".split()

BLEND_VAL = """5b7a3890fc8fcf6781e2593a 5c189f2326173c3a09ed7ef3
5b950c71608de421b1e7318f 5a6400933d809f1d8200af15 59d2657f82ca7774b1ec081d
5ba19a8a360c7c30c1c169df 59817e4a1bd4b175e7038d19""".split()

ALL_LISTS = {
    "dtu/train.txt": DTU_TRAIN,
    "dtu/val.txt": DTU_VAL,
    "dtu/test.txt": DTU_TEST,
    "tank/intermediate.txt": TANK_INTERMEDIATE,
    "tank/advanced.txt": TANK_ADVANCED,
    "eth3d/train.txt": ETH3D_TRAIN,
    "eth3d/test.txt": ETH3D_TEST,
    "blend/train.txt": BLEND_TRAIN,
    "blend/val.txt": BLEND_VAL,
}


def write_lists(outdir: str = "lists") -> None:
    for rel, scenes in ALL_LISTS.items():
        path = os.path.join(outdir, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write("\n".join(scenes) + "\n")


if __name__ == "__main__":
    write_lists(sys.argv[1] if len(sys.argv) > 1 else "lists")
